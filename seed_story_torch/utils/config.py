"""YAML configs with hydra-style ``_target_`` keys; the port's own copy of
``seed_story_tpu/utils/config.py``, reading the same ``configs/`` files.

A ``_target_`` under ``seed_story_tpu.data.``, ``seed_story_tpu.utils.`` or
``seed_story_tpu.models.discrete.`` resolves to its counterpart under
``seed_story_torch.`` (the port's copies of the framework-free modules, and
the discrete models, which a YAML builds directly). Any other
``seed_story_tpu.`` target is refused: the port imports nothing of the JAX
package. Model YAMLs name JAX config classes and go through
``train_clm_sft.port_config`` instead. The reference's ``src.*`` and
``transformers.*`` names resolve through ``TARGET_ALIASES`` to the port's
counterparts of what the JAX package resolves them to, and a JAX dtype
(``jax.numpy.float32``) to the torch dtype of that name. PyYAML is imported
only to read a file.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

JAX_PACKAGE = "seed_story_tpu."
PORT_PACKAGE = "seed_story_torch."
PORTED_SUBPACKAGES = ("data.", "utils.", "models.discrete.")
JAX_DTYPES = "jax.numpy."

# the reference's _target_ names -> the port's counterparts of the JAX
# package's targets for them (seed_story_tpu/utils/config.py)
TARGET_ALIASES: Dict[str, str] = {
    "src.models.qwen_visual.VisionTransformerWithAttnPool.from_pretrained":
        "seed_story_torch.models.vit.VisionTransformerWithAttnPool",
    "src.models.qwen_visual.Resampler":
        "seed_story_torch.models.resampler.Resampler",
    "src.models_clm.models.ContinuousLVLM.from_pretrained":
        "seed_story_torch.models.agent.ContinuousLVLM",
    "src.models_ipa.resampler.ResamplerXLV2":
        "seed_story_torch.models.ipa_resampler.ResamplerXLV2",
    "src.models_ipa.resampler.ResamplerXL":
        "seed_story_torch.models.ipa_resampler.ResamplerXL",
    "src.models_ipa.adapter_modules.SDXLAdapter.from_pretrained":
        "seed_story_torch.models.sdxl.adapter.SDXLAdapter",
    "src.processer.transforms.get_transform":
        "seed_story_torch.data.transforms.get_transform",
    "src.data.story_telling.build_long_story_datapipe":
        "seed_story_torch.data.builders.build_long_story_datapipe",
    "src.data.story_telling.build_t2i_datapipe":
        "seed_story_torch.data.builders.build_t2i_datapipe",
    "src.data.story_telling.build_multi_datapipes":
        "seed_story_torch.data.builders.build_multi_datapipes",
    "transformers.LlamaTokenizer.from_pretrained":
        "seed_story_torch.data.tokenizer.load_llama_tokenizer",
    "src.models.discrete_models.DiscreteModleIdentity":
        "seed_story_torch.models.discrete.DiscreteModelIdentity",
}


def port_target(path: str) -> str:
    """The dotted path the port resolves for a YAML ``_target_``."""
    path = TARGET_ALIASES.get(path, path)
    if path.startswith(JAX_DTYPES):
        return "torch." + path[len(JAX_DTYPES):]
    if not path.startswith(JAX_PACKAGE):
        return path
    rest = path[len(JAX_PACKAGE):]
    if not rest.startswith(PORTED_SUBPACKAGES):
        raise ValueError(
            f"_target_ {path!r} names the JAX package; the port maps only "
            f"{', '.join(JAX_PACKAGE + s + '*' for s in PORTED_SUBPACKAGES)} "
            f"onto its own modules")
    return PORT_PACKAGE + rest


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f)


def resolve_target(path: str) -> Any:
    path = port_target(path)
    parts = path.split(".")
    for split in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:split]))
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    raise ImportError(f"cannot resolve _target_: {path}")


def instantiate(cfg: Any, **overrides) -> Any:
    """hydra.utils.instantiate (a subset): a dict with ``_target_`` becomes a
    call; ``_recursive_: False`` leaves nested configs to the target."""
    if isinstance(cfg, str):
        cfg = load_config(cfg)
    if not isinstance(cfg, dict) or "_target_" not in cfg:
        return cfg
    cfg = dict(cfg)
    target = resolve_target(cfg.pop("_target_"))
    recursive = cfg.pop("_recursive_", True)
    cfg.pop("_convert_", None)
    kwargs = {}
    for k, v in cfg.items():
        if recursive and isinstance(v, dict) and "_target_" in v:
            kwargs[k] = instantiate(v)
        elif recursive and isinstance(v, list):
            kwargs[k] = [instantiate(x) if isinstance(x, dict) and "_target_" in x else x
                         for x in v]
        else:
            kwargs[k] = v
    kwargs.update(overrides)
    return target(**kwargs)
