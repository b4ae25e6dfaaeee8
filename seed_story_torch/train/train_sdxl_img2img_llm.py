"""Stage-3 de-tokenizer adaptation entry point of the port: frozen ViT ->
frozen LoRA agent -> frozen VAE encode of the target frames; the SDXLAdapter
(ResamplerXLV2 and every UNet ``to_k`` / ``to_v``) trains on the eps-MSE, on
one device or over the ranks of a process group. Counterpart of
``seed_story_tpu/train/train_sdxl_img2img_llm.py`` with the same flags and
YAML configs (``scripts/adapt_storystream.sh``):

  python -m seed_story_torch.train.train_sdxl_img2img_llm \\
    --image_transform configs/processer/qwen_448_transform.yaml \\
    --sd_image_transform configs/processer/sd_transform_1024.yaml \\
    --tokenizer configs/tokenizer/clm_llama_tokenizer.yaml \\
    --visual_encoder configs/visual_tokenizer/qwen_vitg_448.yaml \\
    --llm_model configs/clm_models/llama2chat7b_lora.yaml \\
    --agent_model configs/clm_models/agent_7b_sft.yaml \\
    --adapter configs/detokenizer/detokenizer_sdxl_qwen_vit_pretrained.yaml \\
    --vae configs/detokenizer/sdxl_vae.yaml \\
    --train_dataset configs/data/george_sdxl.yaml \\
    --output_dir output/adapt_storystream --learning_rate 1e-4 ...

YAMLs are read as ``train_clm_sft`` reads them. It trains on the card and
raises when there is none; ``main(argv, device="cpu")`` trains on the CPU
instead.

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
from ..models.agent import ContinuousLVLM
from ..models.sdxl.adapter import SDXLAdapter, adapter_trainable_mask
from ..models.sdxl.vae import AutoencoderKL, VAEConfig
from ..models.vit import VisionTransformerWithAttnPool
from ..parallel.mesh import start_ranks
from ..utils.config import instantiate, load_config
from .checkpoint import load_params_partial
from .runner import RunnerArgs, run_training
from .stage3 import make_stage3_loss_fn
from .train_clm_sft import port_config
from .trainer import TrainConfig


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image_transform", required=True)
    p.add_argument("--sd_image_transform", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--visual_encoder", required=True)
    p.add_argument("--llm_model", required=True)
    p.add_argument("--agent_model", required=True)
    p.add_argument("--adapter", required=True)
    p.add_argument("--vae", default=None, help="VAE config yaml (default: SDXL base)")
    p.add_argument("--train_dataset", required=True)
    p.add_argument("--pretrained_agent_path", default=None)
    p.add_argument("--pretrained_vit_path", default=None)
    p.add_argument("--pretrained_adapter_path", default=None)
    p.add_argument("--pretrained_vae_path", default=None)
    p.add_argument("--output_dir", default="output/sdxl_adapt")
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--gradient_accumulation_steps", type=int, default=4)
    p.add_argument("--lr_scheduler_type", default="cosine")
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--max_steps", type=int, default=1600)
    p.add_argument("--min_lr_ratio", type=float, default=0.05)
    p.add_argument("--save_steps", type=int, default=400)
    p.add_argument("--log_steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mesh_data", type=int, default=None)
    p.add_argument("--sharding", default="fsdp", choices=["dp", "fsdp", "fsdp_tp"])
    p.add_argument("--mesh_model", type=int, default=1)
    return p.parse_args(argv)


def _frozen(module, path):
    """``module`` with the parameters saved at ``path`` (when given) loaded
    over it, frozen for the loss."""
    if path:
        module.load_state_dict(load_params_partial(path, module.state_dict())[0])
    return module.eval().requires_grad_(False)


def main(argv=None, device: str = "cuda"):
    args = parse_args(argv)
    device = start_ranks(device, args.mesh_data, args.mesh_model)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("stage-3 training needs a CUDA device and none is available")

    tokenizer = instantiate(load_config(args.tokenizer))
    image_transform = instantiate(load_config(args.image_transform))
    sd_image_transform = instantiate(load_config(args.sd_image_transform))
    vit_cfg = port_config(load_config(args.visual_encoder))
    llm_cfg = port_config(load_config(args.llm_model))
    agent_cfg = port_config(load_config(args.agent_model), llm=llm_cfg)
    adapter_cfg = port_config(load_config(args.adapter))
    vae_cfg = (port_config(load_config(args.vae)) if args.vae
               else VAEConfig(dtype=llm_cfg.dtype))

    # the frozen stages, closed over by the loss
    vit = _frozen(fill_module(VisionTransformerWithAttnPool, vit_cfg, device, seed=0),
                  args.pretrained_vit_path)
    agent = _frozen(fill_module(ContinuousLVLM, agent_cfg, device, seed=1),
                    args.pretrained_agent_path)
    vae = _frozen(fill_module(AutoencoderKL, vae_cfg, device, seed=2),
                  args.pretrained_vae_path)
    adapter = fill_module(SDXLAdapter, adapter_cfg, device, seed=args.seed)
    if args.pretrained_adapter_path:
        adapter.load_state_dict(load_params_partial(args.pretrained_adapter_path,
                                                    adapter.state_dict())[0])

    datapipe = instantiate(load_config(args.train_dataset), tokenizer=tokenizer,
                           image_transform=image_transform,
                           sd_image_transform=sd_image_transform)

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
        seed=args.seed, mesh_data=args.mesh_data, mesh_model=args.mesh_model)
    return run_training(runner_args, train_cfg, adapter,
                        make_stage3_loss_fn(adapter, agent, vae, vit), batches(),
                        trainable_mask=adapter_trainable_mask(adapter, adapter_cfg.full_ft),
                        config_record=vars(args),
                        data_source=datapipe if hasattr(datapipe, "state") else None)


if __name__ == "__main__":
    main()
