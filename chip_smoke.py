"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the process
exits non-zero:

1. device: the card's name and power limit, and the kernel build;
2. kernels: every hand-written kernel against its plain PyTorch version at
   the shapes the main path gives it, with errors and times;
3. story: the port's main path at full width (LLaMA-2-7B + LoRA agent,
   ViT-bigG, SDXL-base UNet + ResamplerXLV2, SDXL VAE) on seeded random
   bf16 weights: one 3-segment story of 1024x1024 images through
   ``build_stack`` -> ``StoryGenerationPipeline.run``, with the kernel's
   launch count checked per stage.

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from seed_story_torch.inference.common import build_stack
from seed_story_torch.models.agent import AgentConfig
from seed_story_torch.models.llama import LlamaConfig
from seed_story_torch.models.sdxl.adapter import SDXLAdapterConfig
from seed_story_torch.models.sdxl.unet import SDXLUNetConfig
from seed_story_torch.models.sdxl.vae import VAEConfig
from seed_story_torch.models.vit import ViTConfig
from seed_story_torch.ops.attention import flash_fwd, mha, mha_reference_lse
from seed_story_torch.pipelines.story_generation import (
    StoryGenerationPipeline,
    StoryPipelineConfig,
)

# Kernel against its plain version, both from the same bf16 inputs; the plain
# version computes in f32. The bound is set by rounding P to bf16 before PV.
O_MAX_ABS, O_MEAN_ABS, LSE_MAX_ABS = 2e-2, 2e-3, 1e-3


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    label = card_label()
    print(label, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = flash_fwd.build()
    print(f"flash_fwd build: {time.perf_counter() - t0:.3f} s "
          f"(nvcc {built.build_seconds:.3f} s) -> {built.path.name}", flush=True)
    for line in built.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    return label


# (name, B, Hq, Hkv, Sq, Skv, D, causal, q_start, kv_len, layout)
# layout "bhsd" is contiguous (B, H, S, D); "bshd" is the (B, S, H, D)
# projection output viewed as (B, H, S, D), as the models pass it.
KERNEL_CASES = [
    ("llama_prefill", 1, 32, 32, 384, 640, 128, True, 0, 384, "bshd"),
    ("vit_bigG_self", 1, 16, 16, 1024, 1024, 104, False, None, None, "bshd"),
    ("vit_attn_pool", 1, 32, 32, 256, 1024, 128, False, None, None, "bshd"),
    ("agent_input_resampler", 3, 32, 32, 64, 256, 128, False, None, None, "bshd"),
    ("agent_output_resampler", 1, 32, 32, 256, 64, 128, False, None, None, "bshd"),
    ("unet_self_64x64", 2, 10, 10, 4096, 4096, 64, False, None, None, "bshd"),
    ("unet_self_32x32", 2, 20, 20, 1024, 1024, 64, False, None, None, "bshd"),
    ("unet_cross_64x64", 2, 10, 10, 4096, 64, 64, False, None, None, "bshd"),
    ("unet_cross_32x32", 2, 20, 20, 1024, 64, 64, False, None, None, "bshd"),
    ("ragged_gqa_causal", 2, 8, 2, 200, 333, 128, True, [133, 50], [333, 170], "bhsd"),
    ("empty_rows", 2, 4, 4, 100, 300, 80, True, [-10, 5], [300, 0], "bhsd"),
    ("unaligned_d100", 2, 4, 4, 77, 150, 100, False, None, [150, 91], "bshd"),
]


def _make(b, h, s, d, layout, gen):
    if layout == "bshd":
        return torch.randn(b, s, h, d, generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
    return torch.randn(b, h, s, d, generator=gen, device="cuda").to(torch.bfloat16)


def _time_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(label: str):
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, failed = [], []
    for name, b, hq, hkv, sq, skv, d, causal, q_start, kv_len, layout in KERNEL_CASES:
        q = _make(b, hq, sq, d, layout, gen)
        k = _make(b, hkv, skv, d, layout, gen)
        v = _make(b, hkv, skv, d, layout, gen)
        kw = dict(causal=causal, q_start=q_start, kv_len=kv_len)
        o, lse = mha(q, k, v, implementation="kernel", with_lse=True, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = mha_reference_lse(q.float(), k.float(), v.float(), **kw)
        err = (o.float() - o_ref).abs()
        finite = torch.isfinite(lse_ref)
        if not torch.equal(finite, torch.isfinite(lse)):
            failed.append(f"{name} (LSE -inf pattern)")
        lse_err = float((lse - lse_ref)[finite].abs().max()) if finite.any() else 0.0
        lse_mean = float((lse - lse_ref)[finite].abs().mean()) if finite.any() else 0.0
        row = dict(name=name, shape=[b, hq, hkv, sq, skv, d], causal=causal,
                   o_max_abs=float(err.max()), o_mean_abs=float(err.mean()),
                   lse_max_abs=lse_err, lse_mean_abs=lse_mean)
        iters = 20 if sq * skv >= 1 << 20 else 50
        t = [_time_ms(lambda: mha(q, k, v, implementation=impl, **kw), iters)
             for impl in ("plain", "kernel", "kernel", "plain")]
        row["ms"] = (t[1] + t[2]) / 2
        row["plain_ms"] = (t[0] + t[3]) / 2
        print(f"kernel {name}: {json.dumps(row)} [{label}]", flush=True)
        if (row["o_max_abs"] > O_MAX_ABS or row["o_mean_abs"] > O_MEAN_ABS
                or row["lse_max_abs"] > LSE_MAX_ABS):
            failed.append(name)
        rows.append(row)
    if failed:
        raise AssertionError(f"kernel disagrees with the plain version at {failed}")
    return rows


# Cuts for time; widths and depths are the configs' own.
SEGMENTS, WINDOW = 3, 8
MAX_NEW = 160
FORCE_BOI_AT = MAX_NEW - 64 - 8
EULER_STEPS = 8


class StageClock:
    """Times module calls (host clock around synchronized work) and counts
    the flash kernel's launches inside each, by stage name."""

    def __init__(self):
        self.calls = defaultdict(list)  # stage -> [(seconds, kernel launches)]

    def watch(self, module, stage_of):
        start = {}

        def before(mod, args, kwargs):
            torch.cuda.synchronize()
            start["t"], start["n"] = time.perf_counter(), flash_fwd.launches

        def after(mod, args, kwargs, out):
            torch.cuda.synchronize()
            self.calls[stage_of(args, kwargs)].append(
                (time.perf_counter() - start["t"], flash_fwd.launches - start["n"]))

        module.register_forward_pre_hook(before, with_kwargs=True)
        module.register_forward_hook(after, with_kwargs=True)

    def launches(self, stage: str) -> int:
        return sum(n for _, n in self.calls[stage])

    def mean_ms(self, stage: str) -> float:
        return 1e3 * float(np.mean([t for t, _ in self.calls[stage]]))


def phase_story(label: str):
    """The port's main path at full width on seeded random bf16 weights."""
    bf16 = torch.bfloat16
    vit_cfg = ViTConfig(param_dtype=bf16)  # configs/visual_tokenizer/qwen_vitg_448.yaml
    llm_cfg = LlamaConfig(lora_rank=16, lora_alpha=32.0, lora_dropout=0.05,
                          param_dtype=bf16)  # configs/clm_models/llama2chat7b_lora.yaml
    agent_cfg = AgentConfig(llm=llm_cfg)  # configs/clm_models/agent_7b_sft.yaml
    adapter_cfg = SDXLAdapterConfig(unet=SDXLUNetConfig(param_dtype=bf16))  # detokenizer yaml
    vae_cfg = VAEConfig(param_dtype=bf16)  # configs/detokenizer/sdxl_vae.yaml
    print(f"cuts: {SEGMENTS} generated segments (window {WINDOW}), max_new_tokens={MAX_NEW} "
          f"with force_boi_at={FORCE_BOI_AT} and EOS banned, {EULER_STEPS} Euler steps "
          f"instead of 50; widths and depths not cut", flush=True)

    t0 = time.perf_counter()
    stack = build_stack(vit_cfg, agent_cfg, adapter_cfg, vae_cfg, seed=0, device="cuda",
                        max_new_tokens=MAX_NEW, num_inference_steps=EULER_STEPS,
                        image_size=1024, force_boi_at=FORCE_BOI_AT, eos_token_id=-1)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (stack.vit, stack.agent, stack.image_pipe.adapter,
                                       stack.image_pipe.vae) for p in m.parameters())
    print(f"build_stack: {time.perf_counter() - t0:.2f} s, {n_params / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated [{label}]", flush=True)

    clock = StageClock()
    clock.watch(stack.vit, lambda a, k: "vit_encode")
    clock.watch(stack.agent.llm, lambda a, k: (
        "prefill" if k["inputs_embeds"].shape[1] > 1 else "decode_token"))
    clock.watch(stack.image_pipe.adapter.unet, lambda a, k: "unet_cfg_step")
    clock.watch(stack.image_pipe.vae.decoder, lambda a, k: "vae_decode")

    pipe = StoryGenerationPipeline(stack.tokenizer, stack.generator, stack.visual_encode,
                                   stack.detokenize, StoryPipelineConfig(
                                       story_len=SEGMENTS + 1, window_size=WINDOW,
                                       num_img_in_tokens=agent_cfg.num_img_in_tokens))
    pixels = np.random.RandomState(0).randn(1, 3, 448, 448).astype(np.float32)
    flash_fwd.launches = 0
    segments, seg_s = [], []
    t_prev = time.perf_counter()
    for seg in pipe.run(pixels, "george the monkey went to the park"):
        torch.cuda.synchronize()
        seg_s.append(time.perf_counter() - t_prev)
        segments.append(seg)
        t_prev = time.perf_counter()
    launches = flash_fwd.launches

    failures = []
    if len(segments) != SEGMENTS:
        failures.append(f"{len(segments)} segments, expected {SEGMENTS}")
    for seg in segments:
        img = seg.image
        if img is None or img.shape != (1024, 1024, 3) or img.dtype != np.uint8:
            failures.append(f"segment {seg.index}: image {None if img is None else img.shape}")
        elif img.min() == img.max():
            failures.append(f"segment {seg.index}: constant image")
        if seg.image_features is None or not bool(torch.isfinite(seg.image_features).all()):
            failures.append(f"segment {seg.index}: features missing or not finite")
        print(f"segment {seg.index}: {len(seg.text.split())} words, context "
              f"{seg.context_tokens} tokens, image {None if img is None else img.shape} "
              f"mean {None if img is None else float(img.mean()):.2f}", flush=True)
    for stage in ("vit_encode", "prefill", "unet_cfg_step"):
        if clock.launches(stage) == 0:
            failures.append(f"flash kernel not launched during {stage}")
    if launches == 0:
        failures.append("flash kernel not launched on the main path")
    if "jax" in sys.modules:
        failures.append("jax was imported")

    for stage in ("vit_encode", "prefill", "decode_token", "unet_cfg_step", "vae_decode"):
        print(f"stage {stage}: {clock.mean_ms(stage):.3f} ms mean over "
              f"{len(clock.calls[stage])} calls, flash launches {clock.launches(stage)} "
              f"[{label}]", flush=True)
    print(f"stage segment: {np.mean(seg_s):.3f} s/segment mean "
          f"({', '.join(f'{s:.3f}' for s in seg_s)}) [{label}]", flush=True)
    print(f"main path: {launches} flash launches, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{label}]", flush=True)
    if failures:
        raise AssertionError(f"story phase failed: {failures}")
    return launches


def main():
    label = phase_device()
    rows = phase_kernels(label)
    launches = phase_story(label)
    at = next(r for r in rows if r["name"] == "unet_self_64x64")
    print(label, flush=True)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": "seed_story_torch/csrc/flash_fwd.cu",
        "replaces": "seed_story_tpu/ops/attention.py:180", "launches": launches,
        "max_abs_err": max(r["o_max_abs"] for r in rows), "ms": at["ms"],
        "plain_ms": at["plain_ms"], "at": at["name"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
