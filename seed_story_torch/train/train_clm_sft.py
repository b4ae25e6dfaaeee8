"""Stage-2 MLLM SFT entry point of the port: frozen ViT -> LoRA'd LLaMA agent,
CE + cosine losses, AdamW with the cosine-min-ratio schedule, on one device
or over the ranks of a process group; counterpart of
``seed_story_tpu/train/train_clm_sft.py`` with the same flags and YAML
configs.

  python -m seed_story_torch.train.train_clm_sft \\
    --image_transform configs/processer/qwen_448_transform.yaml \\
    --tokenizer configs/tokenizer/clm_llama_tokenizer.yaml \\
    --visual_encoder configs/visual_tokenizer/qwen_vitg_448.yaml \\
    --llm_model configs/clm_models/llama2chat7b_lora.yaml \\
    --agent_model configs/clm_models/agent_7b_sft.yaml \\
    --train_dataset configs/data/george_sft.yaml \\
    --output_dir output/sft --learning_rate 1e-4 ...

The model YAMLs name the JAX package's config classes; they become the
port's config dataclasses of the same name, with JAX dtypes mapped by
name. The tokenizer, image transform and data pipeline YAMLs name the JAX
package's builders under ``seed_story_tpu.data``; ``utils.config`` resolves
each to the port's own copy under ``seed_story_torch.data`` and refuses
any other ``seed_story_tpu.`` target. It trains on the card and raises
when there is none; ``main(argv, device="cpu")`` trains on the CPU instead.

A LLaMA YAML with ``quantize_base: true`` (the one-chip recipe,
``configs/clm_models/llama2chat7b_lora_onechip.yaml``) trains LoRA over a
frozen int8 base: the agent is built float, filled, and its seven
projections quantized in place (``quantize_agent_``), the int8 products on
the card going through kernels A and C with the gradient to x through
kernel C. ``--pretrained_agent_path`` loads a float checkpoint before the
quantization and an int8 one (a ``quantize_base`` run's) after it. The int8
weights and their scales never reach the optimizer.

Under ``torchrun --nproc_per_node N`` (or any launcher that sets
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) each rank runs ``main``:
``--mesh_data`` x ``--mesh_model`` must span the N ranks, and
``--sharding`` (dp / fsdp / fsdp_tp) lays the model out over them
(``train/trainer.py``, ``parallel/sharding.py``): ``dp`` replicates it;
``fsdp`` shards every parameter over ``data`` (FSDP2 units; a
``quantize_base`` base's int8 weights and scales as each rank's row slice
outside FSDP, which the product gathers; a unit's minority-dtype trainable
parameters whole); ``fsdp_tp`` adds the Megatron split over ``model`` of the
seven projections and of the vocabulary (``embed_tokens`` by rows,
``lm_head`` by columns, the cross-entropy over vocabulary shards). With
CUDA the group is NCCL and rank r trains on card ``LOCAL_RANK`` modulo the
visible cards. Without a process group the mesh is 1 x 1 and the model
trains unwrapped. A checkpoint holds the whole state, so a run resumes at
another mesh (``--resume_from_checkpoint``).
"""

from __future__ import annotations

import argparse
import logging
from typing import Any, Dict

import torch

from ..data.story_telling import flatten_images
from ..inference.common import fill_module, quantize_agent_
from ..models.agent import AgentConfig, ContinuousLVLM
from ..models.llama import LlamaConfig, lora_trainable_mask
from ..models.sdxl.adapter import SDXLAdapterConfig
from ..models.sdxl.unet import SDXLUNetConfig
from ..models.sdxl.vae import VAEConfig
from ..models.vit import ViTConfig, VisionTransformerWithAttnPool
from ..parallel.mesh import start_ranks
from ..utils.config import instantiate, load_config
from .checkpoint import load_checkpoint_
from .runner import RunnerArgs, run_training
from .stage2 import make_stage2_loss_fn
from .trainer import TrainConfig

log = logging.getLogger("seed_story_torch")

CONFIG_CLASSES = {cls.__name__: cls for cls in (ViTConfig, LlamaConfig, AgentConfig,
                                                SDXLAdapterConfig, SDXLUNetConfig, VAEConfig)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
# JAX-only options: a scanned layer stack changes the parameter layout, not
# the numbers, so it is dropped; the others are refused. The callers that
# take ``quantize_base`` (this entry, ``build_stack_from_yaml``) pop it from
# the YAML first and quantize the filled float agent in place.
IGNORED_OPTIONS = ("scan_layers",)
NOT_PORTED_OPTIONS = ("quantize_base", "quantize_kv", "shard_attention_axis")


def port_config(raw: Dict[str, Any], **overrides):
    """A model YAML (``_target_`` naming a JAX config class) -> the port's
    config dataclass of the same name; a nested config (the adapter's
    ``unet``) is mapped the same way, and lists become tuples."""
    raw = dict(raw)
    name = raw.pop("_target_").rsplit(".", 1)[-1]
    if name not in CONFIG_CLASSES:
        raise ValueError(f"no port config for {name}")
    kwargs = {}
    for key, value in raw.items():
        if key in IGNORED_OPTIONS:
            log.info("%s: %s=%s has no effect in the port", name, key, value)
            continue
        if key in NOT_PORTED_OPTIONS:
            if value:
                raise ValueError(f"{name}.{key}={value} is not ported yet")
            continue
        if isinstance(value, dict) and "path" in value:  # {_target_: resolve_target, path: dtype}
            value = DTYPES[value["path"].rsplit(".", 1)[-1]]
        elif isinstance(value, dict) and "_target_" in value:
            value = port_config(value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[key] = value
    kwargs.update(overrides)
    return CONFIG_CLASSES[name](**kwargs)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image_transform", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--visual_encoder", required=True)
    p.add_argument("--llm_model", required=True)
    p.add_argument("--agent_model", required=True)
    p.add_argument("--train_dataset", required=True)
    p.add_argument("--pretrained_agent_path", default=None)
    p.add_argument("--pretrained_vit_path", default=None)
    p.add_argument("--output_dir", default="output/sft")
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--lr_scheduler_type", default="cosine")
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--max_steps", type=int, default=6000)
    p.add_argument("--min_lr_ratio", type=float, default=0.05)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--log_steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mesh_data", type=int, default=None)
    p.add_argument("--sharding", default="fsdp", choices=["dp", "fsdp", "fsdp_tp"])
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--profile_start", type=int, default=-1)
    p.add_argument("--profile_stop", type=int, default=-1)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda"):
    args = parse_args(argv)
    device = start_ranks(device, args.mesh_data, args.mesh_model)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("stage-2 training needs a CUDA device and none is available")

    tokenizer = instantiate(load_config(args.tokenizer))
    image_transform = instantiate(load_config(args.image_transform))
    vit_cfg = port_config(load_config(args.visual_encoder))
    llm_raw = dict(load_config(args.llm_model))
    quantize_base = bool(llm_raw.pop("quantize_base", False))
    llm_cfg = port_config(llm_raw)
    agent_cfg = port_config(load_config(args.agent_model), llm=llm_cfg)

    vit = fill_module(VisionTransformerWithAttnPool, vit_cfg, device, seed=0)
    load_checkpoint_(vit, args.pretrained_vit_path)
    vit.eval().requires_grad_(False)  # frozen (the reference's train_clm_sft.py:213-215)
    agent = fill_module(ContinuousLVLM, agent_cfg, device, seed=args.seed)
    load_checkpoint_(agent, args.pretrained_agent_path,
                     (lambda a: quantize_agent_(a, base=True, kv=False)) if quantize_base else None)

    # trainable set: the LoRA recipe on the LLM; both resamplers fully (an
    # int8 base weight and its scale are neither; seed_story_tpu/train/
    # train_clm_sft.py:153-160, trainer.py:114-121)
    mask = lora_trainable_mask(agent)
    for name in mask:
        if name.startswith(("input_resampler.", "output_resampler.")):
            mask[name] = True

    datapipe = instantiate(load_config(args.train_dataset), tokenizer=tokenizer,
                           image_transform=image_transform)

    def batches():
        for batch in iter(datapipe):
            yield flatten_images(batch)

    train_cfg = TrainConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm, lr_scheduler_type=args.lr_scheduler_type,
        warmup_steps=args.warmup_steps, training_steps=args.max_steps,
        min_lr_ratio=args.min_lr_ratio, grad_accum_steps=args.gradient_accumulation_steps,
        sharding_preset=args.sharding)
    runner_args = RunnerArgs(
        output_dir=args.output_dir, max_steps=args.max_steps, save_steps=args.save_steps,
        log_steps=args.log_steps, resume_from_checkpoint=args.resume_from_checkpoint,
        seed=args.seed, profile_start=args.profile_start, profile_stop=args.profile_stop,
        mesh_data=args.mesh_data, mesh_model=args.mesh_model)
    return run_training(runner_args, train_cfg, agent, make_stage2_loss_fn(agent, vit),
                        batches(), trainable_mask=mask, config_record=vars(args),
                        data_source=datapipe if hasattr(datapipe, "state") else None)


if __name__ == "__main__":
    main()
