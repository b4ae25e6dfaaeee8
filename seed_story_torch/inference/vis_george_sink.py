"""Story visualization CLI of the port with the attention-sink KV cache;
counterpart of ``seed_story_tpu/inference/vis_george_sink.py`` with the
same arguments and output files.

Texts are ground truth (the val captions), images are generated; the KV
cache persists across turns and long stories evict old images through the
sink policy (``StoryVisualizationPipeline``). ``--detok_devices N`` renders
the images on N de-tokenizer replicas on the last N devices while the
decode goes on (``pipelined_segments``); decode and replicas never share a
device. Weights are seeded random ones, or the port's own parameter files
through ``--agent_ckpt``, ``--vit_ckpt``, ``--adapter_ckpt`` and
``--vae_ckpt`` (``save_params`` files or training checkpoint directories);
``--sdxl_int8`` runs the int8 UNet. ``--decode_tp N`` decodes
tensor-parallel over the first N visible devices
(``decode/tensor_parallel.py``); more than there are is refused.

  python -m seed_story_torch.inference.vis_george_sink --val_jsonl ... --image_root ...
"""

from __future__ import annotations

import argparse
import os

from ..pipelines.story_visualization import StoryVisualizationPipeline, VisPipelineConfig
from .common import (add_subtitle, build_stack_from_yaml, check_devices, read_jsonl,
                     visible_devices)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tokenizer", default="configs/tokenizer/clm_llama_tokenizer.yaml")
    p.add_argument("--image_transform", default="configs/processer/qwen_448_transform.yaml")
    p.add_argument("--visual_encoder", default="configs/visual_tokenizer/qwen_vitg_448.yaml")
    p.add_argument("--llm_model", default="configs/clm_models/llama2chat7b_lora.yaml")
    p.add_argument("--agent_model", default="configs/clm_models/agent_7b_sft.yaml")
    p.add_argument("--adapter", default="configs/detokenizer/detokenizer_sdxl_qwen_vit_adapted.yaml")
    p.add_argument("--vae_config", default=None)
    p.add_argument("--agent_ckpt", default=None)
    p.add_argument("--vit_ckpt", default=None)
    p.add_argument("--adapter_ckpt", default=None)
    p.add_argument("--vae_ckpt", default=None)
    p.add_argument("--val_jsonl", default="data/json/val.jsonl")
    p.add_argument("--image_root", default="data/image/george_full")
    p.add_argument("--save_dir", default="output")
    p.add_argument("--story_len", type=int, default=25)
    p.add_argument("--window_size", type=int, default=8)
    p.add_argument("--max_new_tokens", type=int, default=500)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--image_size", type=int, default=1024)
    p.add_argument("--no_images", action="store_true")
    p.add_argument("--force_boi_at", type=int, default=None)
    p.add_argument("--max_stories", type=int, default=None)
    p.add_argument("--sdxl_int8", action="store_true",
                   help="weight-only int8 UNet projections/convs (per-output-channel "
                        "scales, quantize_unet_): ~2.4GB less streaming + footprint per "
                        "image; divergence bound pinned in test_torch_unet_int8")
    p.add_argument("--decode_tp", type=int, default=0,
                   help="tensor-parallel decode over the FIRST N visible devices "
                        "(pairs with --detok_devices on the tail devices). 0/1 = one device")
    p.add_argument("--detok_devices", type=int, default=0,
                   help="pipelined de-tokenization: N replicas on the LAST N visible devices "
                        "render images while the sink-cache decode goes on. 0 = inline")
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda"):
    """Runs the CLI on ``device`` (the card unless the caller asks for the
    CPU, as the tests do)."""
    from PIL import Image

    from ..pipelines.serving import DetokenizerPool, pipelined_segments

    args = parse_args(argv)
    devices = visible_devices(device)
    check_devices(args, devices)
    stack = build_stack_from_yaml(
        args.tokenizer, args.image_transform, args.visual_encoder, args.llm_model,
        args.agent_model, adapter_cfg_path=None if args.no_images else args.adapter,
        vae_cfg_path=args.vae_config, device=device, max_new_tokens=args.max_new_tokens,
        num_inference_steps=args.num_inference_steps, image_size=args.image_size,
        force_boi_at=args.force_boi_at, sink=True, sdxl_int8=args.sdxl_int8,
        agent_ckpt=args.agent_ckpt, vit_ckpt=args.vit_ckpt, adapter_ckpt=args.adapter_ckpt,
        vae_ckpt=args.vae_ckpt, decode_tp=args.decode_tp)
    serving = args.detok_devices > 0 and stack.detok_factory is not None
    pipe = StoryVisualizationPipeline(
        stack.tokenizer, stack.generator, stack.visual_encode,
        None if serving else stack.detokenize,
        VisPipelineConfig(story_len=args.story_len, window_size=args.window_size,
                          num_img_in_tokens=stack.num_img_in_tokens))
    pool = (DetokenizerPool(stack.detok_factory, devices[-args.detok_devices:])
            if serving else None)

    data = read_jsonl(args.val_jsonl)
    if args.max_stories:
        data = data[:args.max_stories]
    try:
        for j, d in enumerate(data):
            image = Image.open(os.path.join(args.image_root, d["images"][0])).convert("RGB")
            starting_text, texts = d["captions"][0], d["captions"][1:]
            save_folder = os.path.join(args.save_dir, f"val_{j}")
            os.makedirs(save_folder, exist_ok=True)
            add_subtitle(image, starting_text).save(
                os.path.join(save_folder, "000start_image.jpg"))
            segs = pipe.run(stack.image_transform(image)[None], starting_text, texts)
            if pool is not None:
                segs = pipelined_segments(segs, pool)
            for seg in segs:
                with open(os.path.join(save_folder, "text.txt"), "a+") as f:
                    f.write(seg.text + "\n")
                with open(os.path.join(save_folder, "token.txt"), "a+") as f:
                    f.write(f"context token: (1, {seg.context_tokens})\n")
                print(f"[val_{j}] segment {seg.index}: {seg.text[:80]}")
                if seg.image is not None:
                    frame = Image.fromarray(seg.image)
                    frame.save(os.path.join(save_folder, f"ori_{seg.index:02d}.jpg"))
                    add_subtitle(frame, seg.text).save(
                        os.path.join(save_folder, f"{seg.index:02d}.jpg"))
    finally:
        if pool is not None:
            pool.shutdown()


if __name__ == "__main__":
    main()
