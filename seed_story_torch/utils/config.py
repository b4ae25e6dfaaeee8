"""YAML configs with hydra-style ``_target_`` keys; the port's own copy of
``seed_story_tpu/utils/config.py``, reading the same ``configs/`` files.

A ``_target_`` under ``seed_story_tpu.data.`` or ``seed_story_tpu.utils.``
resolves to its counterpart under ``seed_story_torch.`` (the port's copies
of the framework-free modules). Any other ``seed_story_tpu.`` target is
refused: the port imports nothing of the JAX package. Model YAMLs name JAX
config classes and go through ``train_clm_sft.port_config`` instead. PyYAML
is imported only to read a file.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

JAX_PACKAGE = "seed_story_tpu."
PORT_PACKAGE = "seed_story_torch."
PORTED_SUBPACKAGES = ("data.", "utils.")


def port_target(path: str) -> str:
    """The dotted path the port resolves for a YAML ``_target_``."""
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
