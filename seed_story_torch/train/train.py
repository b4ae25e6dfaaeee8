"""Stage-1 (discrete visual-tokenizer) training entry point of the port: frozen
ViT features -> a ``DiscreteModel*`` loss (distillation, VQ, contrastive),
AdamW with the cosine-min-ratio schedule, on one device or over the ranks of
a process group; counterpart of ``seed_story_tpu/train/train.py`` with the
same flags and YAML configs.

  python -m seed_story_torch.train.train \\
    --image_transform configs/processer/qwen_448_transform.yaml \\
    --tokenizer configs/tokenizer/clm_llama_tokenizer.yaml \\
    --visual_encoder configs/visual_tokenizer/qwen_vitg_448.yaml \\
    --discrete_model <a discrete-model YAML> \\
    --train_dataset <a datapipe YAML, e.g. build_t2i_datapipe> ...

The discrete model's YAML (``seed_story_tpu.models.discrete.*`` targets)
instantiates the port's ``models/discrete.py`` with ``embed_dim`` set to the
ViT's ``output_dim``. The loss metrics logged are those whose names end in
``loss``, as in the JAX entry; its ``codes`` do not reach the host, so no
``code_usage`` is logged there either. A discrete model without parameters
(the shipped ``discrete_identity.yaml``) has nothing to train and is
refused with a ``KeyError``, as the JAX entry fails on its empty parameter
tree. It trains on the card and raises when there is none;
``main(argv, device="cpu")`` trains on the CPU instead.

Under ``torchrun --nproc_per_node N`` (or any launcher that sets
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) each rank runs ``main``:
``--mesh_data`` x ``--mesh_model`` must span the N ranks, and
``--sharding`` (dp / fsdp / fsdp_tp) lays the model out over them
(``train/trainer.py``); with CUDA the group is NCCL and rank r trains on
card ``LOCAL_RANK`` modulo the visible cards. Without a process group the
mesh is 1 x 1 and the model trains unwrapped.
"""

from __future__ import annotations

import argparse

import torch

from ..data.story_telling import flatten_images
from ..inference.common import fill_module
from ..models.vit import VisionTransformerWithAttnPool
from ..parallel.mesh import start_ranks
from ..utils.config import instantiate, load_config
from .. import weights as W
from .checkpoint import load_checkpoint_
from .runner import RunnerArgs, run_training
from .train_clm_sft import port_config
from .trainer import TrainConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image_transform", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--visual_encoder", required=True)
    p.add_argument("--discrete_model", required=True)
    p.add_argument("--train_dataset", required=True)
    p.add_argument("--pretrained_vit_path", default=None)
    p.add_argument("--output_dir", default="output/discrete")
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--lr_scheduler_type", default="cosine")
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--max_steps", type=int, default=10000)
    p.add_argument("--min_lr_ratio", type=float, default=0.05)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--log_steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mesh_data", type=int, default=None)
    p.add_argument("--sharding", default="dp", choices=["dp", "fsdp", "fsdp_tp"])
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda"):
    args = parse_args(argv)
    device = start_ranks(device, args.mesh_data)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("stage-1 training needs a CUDA device and none is available")

    tokenizer = instantiate(load_config(args.tokenizer))
    image_transform = instantiate(load_config(args.image_transform))
    vit_cfg = port_config(load_config(args.visual_encoder))
    vit = fill_module(VisionTransformerWithAttnPool, vit_cfg, device, seed=0)
    load_checkpoint_(vit, args.pretrained_vit_path)
    vit.eval().requires_grad_(False)  # frozen
    with torch.device(device):
        discrete = instantiate(load_config(args.discrete_model), embed_dim=vit_cfg.output_dim)
    if not any(True for _ in discrete.parameters()):
        raise KeyError(f"params: {type(discrete).__name__} has no parameters to train")
    W.init_random_(discrete.to(device), args.seed)

    datapipe = instantiate(load_config(args.train_dataset), tokenizer=tokenizer,
                           image_transform=image_transform, sd_image_transform=None)

    def loss_fn(batch, dropout_seed):
        with torch.no_grad():
            feats = vit(batch["images"])
        out = discrete(feats)
        metrics = {k: v.detach() for k, v in out.items()
                   if k.endswith("loss") and k != "total_loss"}
        return out["total_loss"], metrics

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
        seed=args.seed, mesh_data=args.mesh_data)
    return run_training(runner_args, train_cfg, discrete, loss_fn, batches(),
                        config_record=vars(args),
                        data_source=datapipe if hasattr(datapipe, "state") else None)


if __name__ == "__main__":
    main()
