"""Story generation CLI of the port; counterpart of
``seed_story_tpu/inference/gen_george.py`` with the same arguments and
output files.

For each val story: seed with (first frame, first caption) and generate up
to ``story_len`` interleaved (text, image) segments with window eviction,
saving per-story folders ``val_<j>/`` with ``000start_image.jpg``,
``text.txt``, ``token.txt``, ``ori_XX.jpg`` and the subtitled ``XX.jpg``.
Four flows: sequential (``run``), ``--sink`` (``run_sink``, the KV cache
threaded across segments), ``--batch_stories N`` (N stories in lockstep,
``run_batch``) and ``--detok_devices N`` (``PipelinedStoryServer``: the
lockstep decode with N de-tokenizer replicas on the last N devices, which
never share a device with the decode). Weights are seeded random ones, or the
port's own parameter files through ``--agent_ckpt``, ``--vit_ckpt``,
``--adapter_ckpt`` and ``--vae_ckpt`` (``save_params`` files or training
checkpoint directories); ``--sdxl_int8`` runs the int8 UNet. ``--decode_tp N``
decodes tensor-parallel over the first N visible devices
(``decode/tensor_parallel.py``), the replicas taking the last ones; more
devices than there are is refused.

  python -m seed_story_torch.inference.gen_george --val_jsonl ... --image_root ...
"""

from __future__ import annotations

import argparse
import os

from ..pipelines.story_generation import StoryGenerationPipeline, StoryPipelineConfig
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
    p.add_argument("--no_images", action="store_true",
                   help="skip the SDXL de-tokenizer (text-only debugging)")
    p.add_argument("--force_boi_at", type=int, default=None)
    p.add_argument("--max_stories", type=int, default=None)
    p.add_argument("--batch_stories", type=int, default=1,
                   help="serve N val stories in lockstep through one batched decode "
                        "(StoryGenerator.generate_batch); 1 = one story at a time")
    p.add_argument("--speculate_k", type=int, default=0,
                   help="prompt-lookup speculative decode: verify K drafted tokens + the "
                        "committed token per pass (greedy only; per-row accept counts "
                        "with --batch_stories > 1)")
    p.add_argument("--sink", action="store_true",
                   help="thread the multimodal attention-sink KV cache across segments "
                        "(run_sink): each segment prefills only the new image's block")
    p.add_argument("--sink_max_tokens", type=int, default=None,
                   help="cap on retained sink tokens (default: ~28 tokens retained per "
                        "evicted image)")
    p.add_argument("--cache_capacity", type=int, default=None,
                   help="KV cache slots for the sink flow (default: sized from story_len, "
                        "window and max_new_tokens)")
    p.add_argument("--sdxl_int8", action="store_true",
                   help="weight-only int8 UNet projections/convs (per-output-channel "
                        "scales, quantize_unet_): ~2.4GB less streaming + footprint per "
                        "image; divergence bound pinned in test_torch_unet_int8")
    p.add_argument("--decode_tp", type=int, default=0,
                   help="tensor-parallel decode over the FIRST N visible devices "
                        "(pairs with --detok_devices on the tail devices). 0/1 = one device")
    p.add_argument("--detok_devices", type=int, default=0,
                   help="pipelined serving: N de-tokenizer replicas on the LAST N visible "
                        "devices while decode runs on the first (pipelines/serving.py); "
                        "decode and replicas never share a device. 0 = inline")
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda"):
    """Runs the CLI on ``device`` (the card unless the caller asks for the
    CPU, as the tests do)."""
    from PIL import Image

    args = parse_args(argv)
    if args.sink and (args.batch_stories > 1 or args.detok_devices > 0):
        raise SystemExit("--sink threads ONE story's KV cache across segments; it does not "
                         "compose with --batch_stories > 1 or --detok_devices")
    devices = visible_devices(device)
    check_devices(args, devices)
    cache_capacity = args.cache_capacity
    if cache_capacity is None:
        if args.sink:
            # prompt + window live tokens + decode headroom + the sink budget
            # (~28 retained tokens per evicted image, or the cap)
            sink_budget = (min(args.sink_max_tokens, 28 * args.story_len)
                           if args.sink_max_tokens is not None else 28 * args.story_len)
            need = (80 + args.window_size * (args.max_new_tokens + 70)
                    + args.max_new_tokens + args.speculate_k + 1 + sink_budget)
            cache_capacity = -(-need // 128) * 128
        else:
            cache_capacity = 4096
    stack = build_stack_from_yaml(
        args.tokenizer, args.image_transform, args.visual_encoder, args.llm_model,
        args.agent_model, adapter_cfg_path=None if args.no_images else args.adapter,
        vae_cfg_path=args.vae_config, device=device, max_new_tokens=args.max_new_tokens,
        num_inference_steps=args.num_inference_steps, image_size=args.image_size,
        force_boi_at=args.force_boi_at, batch_stories=args.batch_stories,
        pipelined_detok=args.detok_devices > 0, speculate_k=args.speculate_k,
        sink=args.sink, cache_capacity=cache_capacity, sdxl_int8=args.sdxl_int8,
        agent_ckpt=args.agent_ckpt, vit_ckpt=args.vit_ckpt, adapter_ckpt=args.adapter_ckpt,
        vae_ckpt=args.vae_ckpt, decode_tp=args.decode_tp)

    serving = args.detok_devices > 0 and stack.detok_factory is not None
    pipe = StoryGenerationPipeline(
        stack.tokenizer, stack.generator, stack.visual_encode,
        None if serving else stack.detokenize,
        StoryPipelineConfig(story_len=args.story_len, window_size=args.window_size,
                            num_img_in_tokens=stack.num_img_in_tokens,
                            sink_max_tokens=args.sink_max_tokens))

    data = read_jsonl(args.val_jsonl)
    if args.max_stories:
        data = data[:args.max_stories]

    def start_story(j, d):
        image = Image.open(os.path.join(args.image_root, d["images"][0])).convert("RGB")
        question = d["captions"][0]
        save_folder = os.path.join(args.save_dir, f"val_{j}")
        os.makedirs(save_folder, exist_ok=True)
        add_subtitle(image, question).save(os.path.join(save_folder, "000start_image.jpg"))
        return stack.image_transform(image)[None], question, save_folder

    def save_segment(j, save_folder, seg):
        with open(os.path.join(save_folder, "text.txt"), "a+") as f:
            f.write(seg.text + "\n")
        with open(os.path.join(save_folder, "token.txt"), "a+") as f:
            f.write(f"context token: (1, {seg.context_tokens})\n")
        print(f"[val_{j}] segment {seg.index}: {seg.text[:80]}")
        if seg.image is not None:
            image = Image.fromarray(seg.image)
            image.save(os.path.join(save_folder, f"ori_{seg.index:02d}.jpg"))
            add_subtitle(image, seg.text).save(
                os.path.join(save_folder, f"{seg.index:02d}.jpg"))

    if serving:
        # the lockstep decode on the first device, replicas on the last N;
        # segments stream out as their images complete, in per-story order
        from ..pipelines.serving import DetokenizerPool, PipelinedStoryServer

        pool = DetokenizerPool(stack.detok_factory, devices[-args.detok_devices:])
        server = PipelinedStoryServer(pipe, pool)
        group_n = max(args.batch_stories, 1)
        try:
            for base in range(0, len(data), group_n):
                started = [start_story(base + r, d)
                           for r, d in enumerate(data[base:base + group_n])]
                for r, seg in server.serve_stream([(px, q) for px, q, _ in started]):
                    save_segment(base + r, started[r][2], seg)
        finally:
            pool.shutdown()
        print(f"serving stats: {server.stats()}")
        return

    if args.batch_stories > 1:
        for base in range(0, len(data), args.batch_stories):
            started = [start_story(base + r, d)
                       for r, d in enumerate(data[base:base + args.batch_stories])]
            for round_segs in pipe.run_batch([(px, q) for px, q, _ in started]):
                for r, seg in enumerate(round_segs):
                    if seg is not None:
                        save_segment(base + r, started[r][2], seg)
        return

    run = pipe.run_sink if args.sink else pipe.run
    for j, d in enumerate(data):
        pixels, question, save_folder = start_story(j, d)
        for seg in run(pixels, question):
            save_segment(j, save_folder, seg)


if __name__ == "__main__":
    main()
