"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the process
exits non-zero:

1. device: the card's name and power limit, and the kernel builds;
2. kernels: the flash forward against its plain PyTorch version at the
   shapes the story path and the frozen ViT of training give it, with
   errors, times, TFLOP/s, the bound (the least time the card could take:
   operations at the real head dim over the bf16 peak, or bytes read and
   written once over the memory rate, whichever is larger) and the time of
   one ``F.scaled_dot_product_attention`` call on the same inputs, timed
   here as a yardstick and used nowhere in the port;
3. backward kernels: at the stage-2 training shapes of the LLaMA and the
   resamplers, the forward's edge cases and the stage-3 shapes of the
   UNet (self-attention at 64x64 and 32x32, cross-attention from both onto
   64 keys), the flash forward against the plain forward, and the
   flash backward's dq and dk/dv kernels against the plain backward, with
   errors, a second call that must give the same bits, times, TFLOP/s,
   bounds and SDPA's backward;
4. story: the port's main path at full width (LLaMA-2-7B + LoRA agent,
   ViT-bigG, SDXL-base UNet + ResamplerXLV2, SDXL VAE) on seeded random
   bf16 weights: one 3-segment story of 1024x1024 images through
   ``build_stack`` -> ``StoryGenerationPipeline.run``, with the kernel's
   launch count checked per stage and no input copied for TMA;
5. train: stage 2 at full width (frozen ViT-bigG -> LLaMA-2-7B + LoRA
   agent with remat, chunked CE and bf16 parameters) on seeded random
   weights: ``run_training`` for 4 steps on one repeated batch of 2 x 1280
   tokens and 20 images, with losses, parameters, per-step times, the
   kernels' launches per step and no input copied for TMA (by the forward
   or the backward wrapper) checked;
6. stage3: the de-tokenizer adaptation at full width (frozen ViT-bigG,
   LLaMA-2-7B + LoRA agent and SDXL VAE encoder; the SDXLAdapter's
   resampler and UNet ``to_k`` / ``to_v`` training on the eps-MSE) on seeded
   random weights: ``run_training`` for 4 steps of 2 accumulated
   microbatches on the stage-2 batch plus two 1024x1024 targets, with
   finite losses, frozen weights bit-equal, trained ones changed, the flash
   kernels' launches per step (every UNet attention forward, dq and dk/dv,
   the frozen towers forward) and no input copied for TMA checked; s/step,
   SDXL targets/s, the stage split and peak GiB printed, then one more
   microbatch profiled (device ms, busy share, flash and largest kernels).

Between 3 and 4, the decode kernels and kernel C: the weight-only int8
product for 1-32 rows (``csrc/int8_linear.cu``, kernel A) at the 7B
projections' shapes (1 and 5 rows); kernel C, the int8 GEMM for more rows
(``csrc/int8_gemm.cu``), and its transposed form (the gradient to x) against
their exact plain versions at every shape of the int8 UNet's CFG step at
1024x1024, a flagship prefill of 900 and of 74 rows and the stage-2 batch,
with device ms, its launch plan, bounds, the plain expression and
``F.linear`` on a bf16 copy of W (which the port never calls), the small
grids also under the plans not taken, rows of a 2048-row call bit-equal to a
64-row call, and rows of attn2's 128-row products (K slices on a cluster)
bit-equal to 33-row and 2048-row calls; and
the small-query cache attention (``csrc/decode_attn.cu``, int8 and bf16
caches, 1 and 5 queries, GQA and an empty row) against their plain
versions, with device times, bounds and the library yardsticks (``F.linear``
on a pre-dequantized bf16 weight; SDPA on a dequantized cache with a
boolean mask). Between 4 and 5, the flagship phase on the story phase's
stack: the agent quantized in place (int8 weights, int8 KV cache) and
decoding with prompt-lookup speculation (K = 4) through ``run`` (3
segments), a speculative-against-greedy token check, ``run_sink`` (4
segments, window 2, two evictions) and the visualization flow (3
ground-truth texts, window 2), with the kernels' launches per decode pass
checked, then one verify pass of ``run`` profiled (device time of the
int8 products, the cache attention and the rest, and its wall time), and
``run``'s last prefill profiled on kernel C and on the plain int8 product. After
the flagship phase, on the same stack: the lockstep phase (B = 4 stories
with different seeds through ``run_batch`` for 1 round, kernel A taking the
(4, 5) verify block as 20 rows; each story's tokens against the same story
alone on the same inputs, which may part only at a near tie: each pass's
pick in the other's top 8, within two bf16 quanta of its top; ms per
pass, tokens per pass per row, stories x segments per minute beside the
one-story runs, peak GiB) and the serving phase (the
same 4 seeds through ``PipelinedStoryServer`` with one de-tokenizer replica
on the same card on its own CUDA stream: texts identical to ``run_batch``'s,
images within 2/255, segments in per-story order, the serve wall against the
inline wall and the pool's busy seconds). Those three phases prefill through
kernel C (224 launches a prefill). Then the int8 UNet phase on the same
stack (``--sdxl_int8``): one CFG step of the bf16 UNet, the UNet quantized in
place, the same step on kernel C (one launch per quantized linear layer,
722 at SDXL-base) and on the plain int8 product (gated: correlation >=
0.999), and one 8-step image. After stage 2, the same training with
``quantize_base`` (the one-chip recipe's frozen int8 base): int8 weights and
scales bit-equal after 4 steps, LoRA moved, 3 x 224 kernel C launches a
step, the first loss against the plain int8 product's within 1e-2; s/step,
tokens/s and peak GiB beside the bf16 phase's. The decode kernels' rows cover the
lockstep shapes too: kernel A at 4, 10, 20 and 32 rows (and rows of a
20-row call bit-equal to those of 5-row calls), kernel B over 4 rows of
unequal lengths.

After the decode kernels, the probes phase: the attention probes'
kernels (``csrc/probe_attn.cu``: the variants' online kernel in three
variants at four tile instances, the single pass in its three layouts, the
copy) against their plain versions at the shapes of the JAX probes
(``benchmarks/probe_attn_*.py``), with device ms, the chained ``bench``
time, the bound, the exp floor (the exponentials over the SFU's rate), the
plain version's ms and SDPA's (``q + v`` for the copy, which is also timed
with the L2 flushed before each call), the plan each kernel launched (the
online kernel's held against what the card reports of its instance) and
the ms before its redesign; one line a shape and tile of what the
exponentials cost the online kernel (``exp2`` - ``noexp``, ``base`` -
``exp2``, the exp floor); then the three probes' ``main()``
(``seed_story_torch.benchmarks.probe_attn_*``), with each probe kernel's
launches counted over them.

After stage 3, the phases of stage 1, the IP adapters and the variants,
each at full width on seeded random weights and each freeing its models:
stage1 (``seed_story_torch.train.train.main`` on a text-to-image jsonl +
448x448 jpg workspace that this script writes, through
``build_t2i_datapipe``: the frozen ViT-bigG of ``qwen_vitg_448.yaml`` and a
VQ ``DiscreteModelDistill`` at the ``DiscreteConfig`` defaults, 4 steps of
16 images; s/step, images/s, peak GiB, the losses, and the card's VQ codes
against the f64 argmin), ipa (``IPAdapterSDPipeline`` with
``IPAdapterConfig(image_embedding_dim=4096)``: the SD-1.5 UNet, the ViT-bigG
through ``DiscreteModelIdentity``, seeded text embeds, the SDXL VAE,
512x512, 30 Euler steps at scale 0.8 and 0; s/image, the UNet's CFG step in
wall and device ms, VAE ms, peak GiB), sd21_edit (3 training steps of
``SD21Text2ImageAndEditAdapter`` at 768x768, B = 2, under
``sd21_edit_trainable_mask``), align (3 training steps of
``SEEDLLaMAAlignGeneration`` at LLaMA-2-7B width under
``align_trainable_mask`` on the stage-2 batch, then a greedy 64-token
story with a bf16 cache) and vit_nopool (one forward of the no-pool
ViT-bigG at 448). The forward kernel phase also holds the shapes those
phases first give the flash kernels (cross-attention onto 4, 77 and 81
keys, H = 5 self-attention at S = 4096 and 9216, the SD-1.5 and SD-2.1
UNets' other levels), and the backward phase the SD-2.1 ones; the kernels
line lists them under ``new_shapes`` and ``unet_shapes``.

The parallel slice's phases (``parallel/*``, ``decode/tensor_parallel.py``):
tp_decode, after serving on the same stack (``--decode_tp 2``: a copy of
the int8 agent split over a 1 x 2 mesh whose devices are the one card;
tp = 4 runs on four cards in ``tools/multicard_check.py``; 64 greedy tokens
against the agent at tp = 1 under the lockstep tie rule,
kernel C and the flash forward launched once a layer and projection by
each shard in the prefill, kernels A and B in every decode pass, ms/token
of each; the kernel phases hold every kernel at the shapes of a tp = 2 / 4
shard too, ``tp2_*`` / ``tp4_*``, listed under ``tp_shapes`` in the kernels
line); and after vit_nopool: world_of_one (a process group of this
process alone over NCCL: stage 2 at LLaMA-2-7B width with 8 of 32 layers
and the whole ViT-bigG, 2 steps each of the unwrapped ``Trainer`` and of
the ``dp`` and ``fsdp`` presets on a 1 x 1 mesh, losses, grad norms and
every parameter bit-equal, s/step and peak GiB; then ``quantize_base``
under ``fsdp``: int8 weights and scales bit-equal, 168 kernel C launches a
step), ranks (two processes sharing the card over gloo, since NCCL refuses
two ranks on one device: a ``dp`` step at 7B width with 4 layers against
rank 0's world-of-1 step on the same global batch, and the contrastive
loss with negatives gathered across the ranks against the global batch's),
stage3_ranks (two such processes: stage 3 at SDXL width with the UNet's
depth cut to STAGE3_RANK_DEPTH, one step at (data 1, model 2) ``fsdp_tp``,
the UNet split over ``model``, and one at (2, 1) ``dp``, each against rank
0's world-of-1 step: losses, grad norms, the gradient's cosine, trained and
frozen parameters, every UNet attention's flash launches at the shard's
heads, a rank's share of the UNet's bytes) and framework_free
(``native_available()`` and the image path taken). The kernel phases hold
the flash kernels at a ``model`` = 2 shard's UNet shapes too
(``tp2_unet_*``, forward and backward).

The converter's phase, converted (after unet_int8, once the story stack is
gone): a 7B-width agent (``agent_7b_sft.yaml`` / ``llama2chat7b_lora.yaml``,
2 of 32 layers, seeded random bf16 weights with trained-looking norms and
LoRA B) written as zero_to_fp32 leaves a stage-2 agent (PEFT names, the
layernorms' ``modules_to_save`` copies beside ``original_module`` ones, 32066
rows with the 66 added tokens in a seeded released order and their
added_tokens.json), converted by ``tools/convert_torch_weights.main`` with
``--int8`` and without; the float file loaded through ``load_checkpoint_``
(every entry and the prefill logits equal to the in-memory agent's), the int8
file through ``build_stack``'s call (``quantize_agent_(base=True, kv=True)``:
int8 weights and scales bit-equal to quantizing the agent in memory), then
the flagship decode (int8 KV cache, ``speculate_k=4``, EOS banned) for
CONVERTED_NEW tokens, equal to the in-memory agent's, with kernel C and the
flash forward in the prefill and kernels A and B in every decode pass.
Each phase prints its wall seconds ("phase NAME: S s").

    python3 chip_smoke.py --baseline LOG

also prints each decode kernel's and kernel C's device time beside the one
that LOG (an earlier run of this script, e.g. the parent commit's on the
same card) holds for the same shape and form, and kernel C's sums over a
UNet CFG step and a 900-row prefill beside LOG's.

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import os
import re
import sys
import tempfile
import time
import warnings
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from seed_story_torch.decode.generate import GenerateConfig, StoryGenerator
from seed_story_torch.inference.common import build_stack, fill_module, quantize_agent_
from seed_story_torch.models.agent import (AgentConfig, ContinuousLVLM, SEEDLLaMAAlignGeneration,
                                           align_trainable_mask)
from seed_story_torch.models.discrete import DiscreteModelIdentity
from seed_story_torch.models.ipa_adapters import (IPAdapterConfig, IPAdapterSD, SD21EditAdapterConfig,
                                                  SD21Text2ImageAndEditAdapter,
                                                  sd15_unet_config, sd21_edit_trainable_mask)
from seed_story_torch.models import llama as llama_module
from seed_story_torch.models.llama import (LlamaConfig, LoRADense, RMSNorm, derive_seed,
                                           lora_trainable_mask)
from seed_story_torch.models.sdxl.adapter import (SDXLAdapter, SDXLAdapterConfig,
                                                  adapter_trainable_mask, quantize_adapter_)
from seed_story_torch.models.sdxl.unet import CrossAttention, SDXLUNetConfig, quantized_modules
from seed_story_torch.models.sdxl.vae import AutoencoderKL, VAEConfig
from seed_story_torch.models.vit import VisionTransformer, ViTConfig, VisionTransformerWithAttnPool
from seed_story_torch.benchmarks import (probe_attn_dma, probe_attn_overhead, probe_attn_variants,
                                          probe_kernels)
from seed_story_torch.benchmarks.common import bench, card_label
from seed_story_torch.benchmarks.common import qkv as probe_qkv
from seed_story_torch.data.tokenizer import (LLAMA_VOCAB_SIZE, TinyTokenizer,
                                             image_comprehension_string, special_tokens)
from seed_story_torch.ops.attention import (
    _normalize_lens,
    _visible,
    decode_attention,
    decode_attn,
    flash_bwd,
    flash_fwd,
    mha,
    mha_backward_reference,
    mha_reference_lse,
)
from seed_story_torch.ops import dense as dense_module
from seed_story_torch.ops.int8_linear import int8_gemm_kernel, int8_linear, int8_linear_kernel
from seed_story_torch.pipelines.ipa_pipeline import IPASampleConfig, IPAdapterSDPipeline
from seed_story_torch.pipelines.serving import DetokenizerPool, PipelinedStoryServer
from seed_story_torch.pipelines.story_generation import (
    StoryGenerationPipeline,
    StoryPipelineConfig,
)
from seed_story_torch.pipelines.story_visualization import (
    StoryVisualizationPipeline,
    VisPipelineConfig,
)
from seed_story_torch.tools.convert_torch_weights import main as convert_weights
from seed_story_torch.train.checkpoint import load_checkpoint_
from seed_story_torch.train.runner import (LAUNCH_COUNTS, RunnerArgs, kernel_launch_counts,
                                           run_training, to_device)
from seed_story_torch.train.stage2 import make_stage2_loss_fn
from seed_story_torch.train.stage3 import make_stage3_loss_fn
from seed_story_torch.train import train as stage1
from seed_story_torch.train.trainer import TrainConfig, Trainer

# Kernel against its plain version, both from the same bf16 inputs; the plain
# version computes in f32. The bound is set by rounding P to bf16 before PV.
O_MAX_ABS, O_MEAN_ABS, LSE_MAX_ABS = 2e-2, 2e-3, 1e-3
# Backward kernels against the plain f32 backward from the same bf16 inputs,
# relative to the reference's own size; set by rounding P and dS to bf16.
GRAD_MAX_REL, GRAD_MEAN_REL = 2e-2, 1e-2
# One H100 SXM (NVIDIA's data sheet, dense): bf16 tensor cores, device memory.
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")
# The int8 product against its plain version from the same inputs: the same
# two bf16 roundings, f32 sums in another order.
INT8_MAX_REL, INT8_MEAN_REL = 1e-2, 1e-3
KERNELS = (("flash_fwd", flash_fwd), ("flash_bwd", flash_bwd),
           ("int8_linear", int8_linear_kernel), ("int8_gemm", int8_gemm_kernel),
           ("decode_attn", decode_attn), ("probe_attn", probe_kernels.probe_attn))


@contextlib.contextmanager
def plain_int8_products():
    """Inside: the int8 products of the UNet's linear layers and the LLaMA's
    projections take their plain version (F.linear on a bf16 copy of W),
    for the comparisons of the int8 UNet and quantize_base train phases.
    The port has no such switch; this script swaps the two modules' name."""
    saved = dense_module.int8_linear, llama_module.int8_linear
    dense_module.int8_linear = llama_module.int8_linear = functools.partial(
        int8_linear, implementation="plain")
    try:
        yield
    finally:
        dense_module.int8_linear, llama_module.int8_linear = saved


def forbidden_imports() -> list:
    """JAX or any module of the JAX package in this process: the port
    imports neither."""
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "seed_story_tpu")))
    return [f"imported {bad[:5]}"] if bad else []


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    label = card_label()
    print(label, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all at once
        builds = list(pool.map(lambda kernel: kernel[1].build(), KERNELS))
    print(f"kernel builds: {time.perf_counter() - t0:.3f} s for {len(KERNELS)} sources "
          f"in parallel", flush=True)
    for (name, _), built in zip(KERNELS, builds):
        print(f"{name} build: nvcc {built.build_seconds:.3f} s -> {built.path.name}", flush=True)
        for line in built.ptxas_log.splitlines():
            if any(w in line for w in ("entry", "registers", "spill", "smem", "arning")):
                print(f"  ptxas: {line.strip()}", flush=True)
        spills = [int(st) + int(ld) for st, ld in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", built.ptxas_log)]
        print(f"{name} ptxas: {len(spills)} instances, {sum(n > 0 for n in spills)} with spills",
              flush=True)
    return label


# The attention shapes first run by the IP adapters and the SD-2.1 edit
# adapter (all d = 64, full, in the projections' (B, S, H, D) views).
NEW_SHAPES = [
    ("sd15_self_64x64", 2, 5, 5, 4096, 4096, 64, False, None, None, "bshd"),
    ("sd15_self_32x32", 2, 10, 10, 1024, 1024, 64, False, None, None, "bshd"),
    ("sd15_self_16x16", 2, 20, 20, 256, 256, 64, False, None, None, "bshd"),
    ("sd15_self_8x8", 2, 20, 20, 64, 64, 64, False, None, None, "bshd"),
    ("ipa_cross81_64x64", 2, 5, 5, 4096, 81, 64, False, None, None, "bshd"),
    ("ipa_cross81_8x8", 2, 20, 20, 64, 81, 64, False, None, None, "bshd"),
    ("ip_image_attn4_64x64", 2, 5, 5, 4096, 4, 64, False, None, None, "bshd"),
    ("sd21_self_96x96", 2, 5, 5, 9216, 9216, 64, False, None, None, "bshd"),
    ("sd21_self_48x48", 2, 10, 10, 2304, 2304, 64, False, None, None, "bshd"),
    ("sd21_self_24x24", 2, 20, 20, 576, 576, 64, False, None, None, "bshd"),
    ("sd21_self_12x12", 2, 20, 20, 144, 144, 64, False, None, None, "bshd"),
    ("sd21_cross77_96x96", 2, 5, 5, 9216, 77, 64, False, None, None, "bshd"),
    ("sd21_cross77_12x12", 2, 20, 20, 144, 77, 64, False, None, None, "bshd"),
]
NEW_SHAPE_NAMES = tuple(case[0] for case in NEW_SHAPES)
# the SD-2.1 edit adapter's training step runs these backward too
NEW_BWD_SHAPES = [case for case in NEW_SHAPES if case[0].startswith("sd21_")]

# A model = 2 shard of the SDXL UNet in stage 3 (parallel/sharding.py::
# split_unet_; 2 targets a rank): self-attention at 64x64 and 32x32 on 5 of
# 10 and 10 of 20 heads, cross-attention from those onto the resampler's 64
# tokens; forward and backward.
UNET_TP2_SHAPES = [
    ("tp2_unet_self_64x64", 2, 5, 5, 4096, 4096, 64, False, None, None, "bshd"),
    ("tp2_unet_self_32x32", 2, 10, 10, 1024, 1024, 64, False, None, None, "bshd"),
    ("tp2_unet_cross_64x64", 2, 5, 5, 4096, 64, 64, False, None, None, "bshd"),
    ("tp2_unet_cross_32x32", 2, 10, 10, 1024, 64, 64, False, None, None, "bshd"),
]

# (name, B, Hq, Hkv, Sq, Skv, D, causal, q_start, kv_len, layout)
# layout "bhsd" is contiguous (B, H, S, D); "bshd" is the (B, S, H, D)
# projection output viewed as (B, H, S, D), as the models pass it.
KERNEL_CASES = [
    ("llama_prefill", 1, 32, 32, 384, 640, 128, True, 0, 384, "bshd"),
    # a --decode_tp 2 / 4 shard's prefill: 16 / 8 of the 32 heads
    ("tp2_llama_prefill", 1, 16, 16, 384, 640, 128, True, 0, 384, "bshd"),
    ("tp4_llama_prefill", 1, 8, 8, 384, 640, 128, True, 0, 384, "bshd"),
    ("vit_bigG_self", 1, 16, 16, 1024, 1024, 104, False, None, None, "bshd"),
    ("vit_attn_pool", 1, 32, 32, 256, 1024, 128, False, None, None, "bshd"),
    # the frozen ViT in stage-2 training: 20 images per step
    ("vit_bigG_self_train", 20, 16, 16, 1024, 1024, 104, False, None, None, "bshd"),
    ("vit_attn_pool_train", 20, 32, 32, 256, 1024, 128, False, None, None, "bshd"),
    ("agent_input_resampler", 3, 32, 32, 64, 256, 128, False, None, None, "bshd"),
    ("agent_output_resampler", 1, 32, 32, 256, 64, 128, False, None, None, "bshd"),
    ("unet_self_64x64", 2, 10, 10, 4096, 4096, 64, False, None, None, "bshd"),
    ("unet_self_32x32", 2, 20, 20, 1024, 1024, 64, False, None, None, "bshd"),
    ("unet_cross_64x64", 2, 10, 10, 4096, 64, 64, False, None, None, "bshd"),
    ("unet_cross_32x32", 2, 20, 20, 1024, 64, 64, False, None, None, "bshd"),
    *UNET_TP2_SHAPES,
    ("ragged_gqa_causal", 2, 8, 2, 200, 333, 128, True, [133, 50], [333, 170], "bhsd"),
    ("empty_rows", 2, 4, 4, 100, 300, 80, True, [-10, 5], [300, 0], "bhsd"),
    ("unaligned_d100", 2, 4, 4, 77, 150, 100, False, None, [150, 91], "bshd"),
    # the IP adapters' SD-1.5 UNet at 512x512 (B = 2 for CFG): self-attention
    # at 64x64 (H = 5), 32x32 (H = 10), 16x16 and the 8x8 mid block (H = 20),
    # cross-attention onto 77 text + 4 image keys; IPCrossAttention's image
    # part onto 4 keys; the SD-2.1 UNet at 768x768: self-attention at 96x96
    # (H = 5), 48x48 (H = 10), 24x24 and 12x12 (H = 20), cross onto 77 keys
    *NEW_SHAPES,
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


def attention_work(b, hq, hkv, sq, skv, d, causal, q_start, kv_len) -> dict:
    """What these inputs need: visible (query, key) pairs summed over the
    heads, the bytes of one bf16 (B, Hq, Sq, d) tensor, of one K or V
    counting only keys some row sees, and of one f32 (B, Hq, Sq) row
    statistic."""
    qs, kl = _normalize_lens(b, sq, skv, q_start, kv_len, "cpu")
    mask = _visible(sq, skv, causal, qs, kl).expand(b, 1, sq, skv)
    return {"pairs": int(mask.sum()) * hq, "q": 2 * b * hq * sq * d,
            "kv": 2 * int(mask.any(dim=2).sum()) * hkv * d, "row": 4 * b * hq * sq,
            "kv_all": 2 * b * hkv * skv * d, "d": d}


def bound(flops: float, nbytes: float):
    """(ms, what binds): the larger of operations over the bf16 peak and
    bytes over the memory rate."""
    ops_ms, bytes_ms = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def forward_bound(w: dict):
    """Q, K, V read, O and LSE written; QK^T and PV at the real head dim."""
    return 4 * w["d"] * w["pairs"], bound(4 * w["d"] * w["pairs"],
                                          2 * w["q"] + 2 * w["kv"] + w["row"])


BWD_FLOPS_PER_PAIR = {"dq": 6, "dkv": 8}  # times d: S, dP and dS K; S, dP, P^T dO and dS^T Q


def backward_bounds(w: dict):
    """dq: reading Q, dO, O, K, V and LSE, writing dq and delta; dk/dv:
    reading Q, dO, K, V, LSE and delta, writing dk and dv for every key."""
    ops = {k: n * w["d"] * w["pairs"] for k, n in BWD_FLOPS_PER_PAIR.items()}
    return (bound(ops["dq"], 4 * w["q"] + 2 * w["kv"] + 2 * w["row"]),
            bound(ops["dkv"], 2 * w["q"] + 2 * w["kv"] + 2 * w["row"] + 2 * w["kv_all"]))


def library_call(q, k, causal, q_start, kv_len):
    """Keyword arguments of one ``F.scaled_dot_product_attention`` call that
    computes the kernel's function on these inputs, and how it masks; None
    where none does (a row with no visible key gives NaN there, not 0)."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    qs, kl = _normalize_lens(b, sq, skv, q_start, kv_len, q.device)
    kw = dict(scale=d ** -0.5, enable_gqa=hq != k.shape[1])
    if bool((kl == skv).all()) and (not causal or (sq == skv and bool((qs == 0).all()))):
        return dict(is_causal=causal, **kw), "is_causal" if causal else "no mask"
    mask = _visible(sq, skv, causal, qs, kl).expand(b, 1, sq, skv)
    if bool(mask.any(dim=-1).all()):
        return dict(attn_mask=mask, **kw), "boolean mask"
    return None, "no single call: rows with no visible key"


def time_library(q, k, v, iters: int, causal, q_start, kv_len, do=None):
    """(device ms per call, backend) of the fastest SDPA backend that takes
    these inputs: the forward, or with ``do`` the backward of dq, dk and dv
    together."""
    call, how = library_call(q, k, causal, q_start, kv_len)
    if call is None:
        return None, how
    best = (None, f"no backend ({how})")
    for name in SDPA_BACKENDS:
        try:
            with warnings.catch_warnings(), sdpa_kernel(getattr(SDPBackend, name)):
                warnings.simplefilter("ignore")
                if do is None:
                    fn = lambda: F.scaled_dot_product_attention(q, k, v, **call)  # noqa: E731
                else:
                    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                    out = F.scaled_dot_product_attention(*leaves, **call)
                    fn = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
                fn()
                ms = _profiled_ms(fn, iters)["all"][0]
        except RuntimeError:
            continue
        if best[0] is None or ms < best[0]:
            best = (ms, f"{name.lower()} ({how})")
    return best


def check_forward(name: str, row: dict, o, lse, o_ref, lse_ref) -> list:
    """Writes the forward kernel's O and LSE errors against the plain
    version's into ``row``; returns what is out of bounds."""
    err = (o.float() - o_ref.float()).abs()
    finite = torch.isfinite(lse_ref)
    lse_err = (lse - lse_ref)[finite].abs() if finite.any() else torch.zeros(1)
    row.update(o_max_abs=float(err.max()), o_mean_abs=float(err.mean()),
               lse_max_abs=float(lse_err.max()), lse_mean_abs=float(lse_err.mean()))
    failed = []
    if not torch.equal(finite, torch.isfinite(lse)):
        failed.append(f"{name} (LSE -inf pattern)")
    if (row["o_max_abs"] > O_MAX_ABS or row["o_mean_abs"] > O_MEAN_ABS
            or row["lse_max_abs"] > LSE_MAX_ABS):
        failed.append(f"{name} (forward)")
    return failed


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
        row = dict(name=name, shape=[b, hq, hkv, sq, skv, d], causal=causal)
        failed += check_forward(name, row, o, lse, o_ref, lse_ref)
        del o_ref, lse_ref
        iters = 5 if sq * skv >= 1 << 26 else 20 if sq * skv >= 1 << 20 else 50
        t = [_time_ms(lambda: mha(q, k, v, implementation=impl, **kw), iters)
             for impl in ("plain", "kernel", "kernel", "plain")]
        row["call_ms"] = (t[1] + t[2]) / 2  # the whole mha call, host path included
        row["plain_ms"] = (t[0] + t[3]) / 2
        row["ms"], row["recorded"] = _profiled_ms(
            lambda: mha(q, k, v, implementation="kernel", **kw), iters, ("flash_fwd_kernel",))[
            "flash_fwd_kernel"]
        flops, (row["bound_ms"], row["bound_by"]) = forward_bound(
            attention_work(b, hq, hkv, sq, skv, d, causal, q_start, kv_len))
        row["tflops"] = flops / row["ms"] / 1e9
        row["roofline"] = row["bound_ms"] / row["ms"]
        row["library_ms"], row["library"] = time_library(q, k, v, iters, **kw)
        print(f"kernel {name}: {json.dumps(row)} [{label}]", flush=True)
        rows.append(row)
    if failed:
        raise AssertionError(f"kernel disagrees with the plain version at {failed}")
    return rows


# (name, B, Hq, Hkv, Sq, Skv, D, causal, q_start, kv_len, layout): the
# training shapes of stage 2 (LLaMA self-attention over B=2 x 1280 tokens,
# the resamplers over N=20 images), the forward's edge cases, and the UNet's
# attentions of stage 3 at B=2: self-attention at the 64x64 and 32x32
# levels, cross-attention from those queries onto the resampler's 64 keys.
BWD_CASES = [
    ("llama_train_causal", 2, 32, 32, 1280, 1280, 128, True, 0, [1280, 1100], "bshd"),
    ("agent_input_resampler", 20, 32, 32, 64, 256, 128, False, None, None, "bshd"),
    ("agent_output_resampler", 20, 32, 32, 256, 64, 128, False, None, None, "bshd"),
    ("ragged_gqa_causal", 2, 8, 2, 200, 333, 128, True, [133, 50], [333, 170], "bhsd"),
    ("empty_rows", 2, 4, 4, 100, 300, 80, True, [-10, 5], [300, 0], "bhsd"),
    ("unaligned_d100", 2, 4, 4, 77, 150, 100, False, None, [150, 91], "bshd"),
    ("unet_self_64x64", 2, 10, 10, 4096, 4096, 64, False, None, None, "bshd"),
    ("unet_self_32x32", 2, 20, 20, 1024, 1024, 64, False, None, None, "bshd"),
    ("unet_cross_64x64", 2, 10, 10, 4096, 64, 64, False, None, None, "bshd"),
    ("unet_cross_32x32", 2, 20, 20, 1024, 64, 64, False, None, None, "bshd"),
    *UNET_TP2_SHAPES,
    *NEW_BWD_SHAPES,
]
UNET_BWD_CASES = tuple(case[0] for case in BWD_CASES
                       if case[0].startswith(("unet_", "sd21_", "tp2_unet_")))


def device_events(events) -> list:
    """The profiler's device-side events (kernels, copies, fills): a CPU
    op's self device time repeats the kernels it launched."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]


def profiled(run, kernels=(), passes: int = 3):
    """The profiler's event averages over one ``run()``, which synchronizes.
    Now and then the profiler records no device event at all; such a pass
    (or one that misses a named kernel) is run again, up to ``passes``."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(passes):
        with torch.profiler.profile(activities=activities) as prof:
            run()
        events = prof.key_averages()
        if device_events(events) and all(any(k in e.key for e in events) for k in kernels):
            return events
    raise AssertionError(f"the profiler recorded no device event, or no launch of one of "
                         f"{list(kernels)}, in {passes} passes")


def _profiled_ms(fn, iters: int, kernels=()) -> dict:
    """(device ms per launch, launches recorded) of each named kernel
    (``fn`` launches each once), from one torch.profiler pass over ``iters``
    calls: the mean over the launches the profiler recorded, which may miss
    some; under "all", the device time of everything per call."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    events = profiled(run, kernels)
    # each device event's mean duration times its launches per call, so that
    # events the profiler dropped do not shorten the sum
    out = {"all": (sum(e.self_device_time_total / e.count * max(1, round(e.count / iters))
                       for e in device_events(events)) / 1e3, iters)}
    for kernel in kernels:
        mine = [e for e in events if kernel in e.key]
        count = sum(e.count for e in mine)
        out[kernel] = (sum(e.device_time_total for e in mine) / 1e3 / count, count)
    return out


def phase_bwd_kernels(label: str):
    """At the training shapes: the forward kernel's O and LSE against the
    plain forward, then flash_bwd (dq and dk/dv kernels, fed the kernel's O
    and LSE) against mha_backward_reference (fed the plain forward's), one
    random dO for both."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, failed = [], []
    for name, b, hq, hkv, sq, skv, d, causal, q_start, kv_len, layout in BWD_CASES:
        q = _make(b, hq, sq, d, layout, gen)
        k = _make(b, hkv, skv, d, layout, gen)
        v = _make(b, hkv, skv, d, layout, gen)
        do = _make(b, hq, sq, d, layout, gen)
        kw = dict(causal=causal, q_start=q_start, kv_len=kv_len)
        o, lse = mha(q, k, v, implementation="kernel", with_lse=True, **kw)
        qs, kl = _normalize_lens(b, sq, skv, q_start, kv_len, "cuda")
        scale = 1.0 / d ** 0.5
        got = flash_bwd(q, k, v, o, lse, do, qs, kl, causal, scale)
        torch.cuda.synchronize()
        f32 = [t.float() for t in (q, k, v, do)]
        o_ref, lse_ref = mha_reference_lse(*f32[:3], scale=scale, **kw)
        row = dict(name=name, shape=[b, hq, hkv, sq, skv, d], causal=causal)
        failed += check_forward(name, row, o, lse, o_ref, lse_ref)

        def plain():
            return mha_backward_reference(*f32[:3], o_ref, lse_ref, f32[3], scale=scale, **kw)

        want = plain()
        for gname, g, w in zip(("dq", "dk", "dv"), got, want):
            err = (g.float() - w).abs()
            row[f"{gname}_max_abs"] = float(err.max())
            row[f"{gname}_max_rel"] = float(err.max() / w.abs().max().clamp_min(1e-30))
            row[f"{gname}_mean_rel"] = float(err.mean() / w.abs().mean().clamp_min(1e-30))
            if not bool(torch.isfinite(g).all()):
                failed.append(f"{name} ({gname} not finite)")
            elif (row[f"{gname}_max_rel"] > GRAD_MAX_REL
                  or row[f"{gname}_mean_rel"] > GRAD_MEAN_REL):
                failed.append(f"{name} ({gname})")
        again = flash_bwd(q, k, v, o, lse, do, qs, kl, causal, scale)
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            failed.append(f"{name} (two backward calls differ)")
        del again
        empty = torch.isinf(lse[..., 0])
        if empty.any() and not bool(torch.all(got[0][empty] == 0)):
            failed.append(f"{name} (dq of empty rows not zero)")
        if any(bool((g[i, :, int(kl[i]):] != 0).any()) for g in got[1:] for i in range(b)):
            failed.append(f"{name} (dk/dv of keys past kv_len not zero)")
        iters = 3 if sq * skv >= 1 << 26 else 10 if sq * skv >= 1 << 22 else 30
        kernel = lambda: flash_bwd(q, k, v, o, lse, do, qs, kl, causal, scale)  # noqa: E731
        t = [_time_ms(fn, iters) for fn in (plain, kernel, kernel, plain)]
        row["ms"] = (t[1] + t[2]) / 2  # both kernels, as the autograd backward runs
        row["plain_ms"] = (t[0] + t[3]) / 2
        per_kernel = _profiled_ms(kernel, iters, ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))
        row["dq_ms"], row["dq_recorded"] = per_kernel["flash_bwd_dq_kernel"]
        row["dkv_ms"], row["dkv_recorded"] = per_kernel["flash_bwd_dkv_kernel"]
        w = attention_work(b, hq, hkv, sq, skv, d, causal, q_start, kv_len)
        (row["dq_bound_ms"], row["dq_bound_by"]), (row["dkv_bound_ms"], row["dkv_bound_by"]) = (
            backward_bounds(w))
        for kname, n in BWD_FLOPS_PER_PAIR.items():
            row[f"{kname}_tflops"] = n * d * w["pairs"] / row[f"{kname}_ms"] / 1e9
            row[f"{kname}_roofline"] = row[f"{kname}_bound_ms"] / row[f"{kname}_ms"]
        row["library_ms"], row["library"] = time_library(q, k, v, iters, **kw, do=do)
        print(f"bwd kernel {name}: {json.dumps(row)} [{label}]", flush=True)
        rows.append(row)
    if failed:
        raise AssertionError(f"backward kernels disagree with the plain version at {failed}")
    return rows


# The int8 product at the 7B agent's projection shapes: (name, M, N, K);
# M = 1 is a decode pass, M = 5 the K + 1 = 5 verify block, M = 4 a lockstep
# decode token of 4 stories, M = 10 / 20 the verify block of 2 / 4 stories in
# lockstep, M = 32 the kernel's most rows. A decode pass runs each shape this
# many times per layer.
INT8_ROWS = (1, 4, 5, 10, 20, 32)
INT8_CASES = [(f"{name}_m{m}", m, n, k) for m in INT8_ROWS
              for name, n, k in (("qkvo", 4096, 4096), ("gate_up", 11008, 4096),
                                 ("down", 4096, 11008))]
PER_LAYER = {"qkvo": 4, "gate_up": 2, "down": 1}
# A --decode_tp 2 / 4 shard's products (decode and verify): q / k / v and
# gate / up on N / tp rows, o and down on K / tp columns (at tp = 4 gate / up
# give N = 2752 and down K = 2752, not multiples of 128).
TP_INT8_SHAPES = tuple((f"tp{tp}_{name}", n, k) for tp in (2, 4) for name, n, k in (
    ("qkv", 4096 // tp, 4096), ("o", 4096, 4096 // tp), ("gate_up", 11008 // tp, 4096),
    ("down", 4096, 11008 // tp)))
INT8_CASES += [(f"{name}_m{m}", m, n, k) for m in (1, 5) for name, n, k in TP_INT8_SHAPES]


def exact_plain_int8(x, w, scale):
    """The plain int8 product as it is defined, its f32 sums rounded to bf16
    once: cuBLAS may otherwise add split-K partial sums in bf16
    (``allow_bf16_reduced_precision_reduction``, on by default)."""
    matmul = torch.backends.cuda.matmul
    flag = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return int8_linear(x, w, scale, implementation="plain")
    finally:
        matmul.allow_bf16_reduced_precision_reduction = flag


def phase_int8_kernel(label: str):
    """Kernel A against its plain version; device ms, bound (bytes: the int8
    weight, x, the scales and y once each), the plain product, F.linear on a
    pre-dequantized bf16 weight (cuBLAS), and the int8 -> bf16 conversion the
    plain product pays (the prefill route). Then, per shape, the rows of a
    20-row call against the same rows in four 5-row calls, bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, failed = [], []
    for name, m, n, k in INT8_CASES:
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand(n, generator=gen, device="cuda") / (127 * k ** 0.5)
        y = int8_linear(x, w, scale, implementation="kernel")
        torch.cuda.synchronize()
        want = exact_plain_int8(x, w, scale).float()
        err = (y.float() - want).abs()
        row = dict(name=name, shape=[m, n, k], max_abs=float(err.max()),
                   max_rel=float(err.max() / want.abs().max()),
                   mean_rel=float(err.mean() / want.abs().mean()))
        if row["max_rel"] > INT8_MAX_REL or row["mean_rel"] > INT8_MEAN_REL:
            failed.append(name)
        kernel = lambda: int8_linear(x, w, scale, implementation="kernel")  # noqa: E731
        plain = lambda: int8_linear(x, w, scale, implementation="plain")  # noqa: E731
        t = [_time_ms(fn, 50) for fn in (plain, kernel, kernel, plain)]
        row["call_ms"], row["plain_ms"] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        row["ms"], row["recorded"] = _profiled_ms(kernel, 50, ("int8_linear_kernel",))[
            "int8_linear_kernel"]
        nbytes = n * k + 2 * m * k + 4 * n + 2 * m * n
        row["bound_ms"], row["bound_by"] = bound(2 * m * n * k, nbytes)
        row["roofline"] = row["bound_ms"] / row["ms"]
        row["tb_per_s"] = nbytes / row["ms"] / 1e9
        w_bf16 = w.to(torch.bfloat16)
        row["library_ms"] = _profiled_ms(lambda: F.linear(x, w_bf16), 50)["all"][0]
        row["dequant_ms"] = _profiled_ms(lambda: w.to(torch.bfloat16), 50)["all"][0]
        print(f"int8_linear {name}: {json.dumps(row)} [{label}]", flush=True)
        rows.append(row)
    n_layers = LlamaConfig().num_hidden_layers
    for m in (1, 4, 5, 20):
        per = {r["name"].rpartition("_m")[0]: r for r in rows if r["shape"][0] == m
               and r["name"].rpartition("_m")[0] in PER_LAYER}
        total = {key: n_layers * sum(PER_LAYER[s] * r[key] for s, r in per.items())
                 for key in ("ms", "bound_ms", "library_ms", "plain_ms", "dequant_ms")}
        print(f"int8_linear per pass of {m} row(s): {7 * n_layers} launches, "
              f"{json.dumps(total)} (dequant_ms: the int8 -> bf16 conversion of a prefill) "
              f"[{label}]", flush=True)
    for name, n, k in (("qkvo", 4096, 4096), ("gate_up", 11008, 4096), ("down", 4096, 11008)):
        x = torch.randn(20, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand(n, generator=gen, device="cuda") / (127 * k ** 0.5)
        whole = int8_linear(x, w, scale, implementation="kernel")
        parts = torch.cat([int8_linear(x[i:i + 5], w, scale, implementation="kernel")
                           for i in range(0, 20, 5)])
        equal = torch.equal(whole, parts)
        print(f"int8_linear {name}: rows of one 20-row call bit-equal to four 5-row calls: "
              f"{equal} [{label}]", flush=True)
        if not equal:
            failed.append(f"{name} (20 rows differ from 4 x 5 rows)")
    if failed:
        raise AssertionError(f"int8_linear disagrees with the plain version at {failed}")
    return rows


# Kernel C, the int8 GEMM for more than 32 rows: (name, M, K, N, with the
# transposed form). The int8 UNet at 1024x1024 with the CFG pair (M = 2 x
# 4096 at C = 640, 2 x 1024 at C = 1280; (K, N) = (C, C), (C, 8C), (4C, C);
# attn2 to_k / to_v at M = 2 x 64 from the 2048-wide context), a flagship
# prefill's rows at the 7B projections (a context near the smoke's ~900, and
# the flagship's shortest prompt, 74 rows: a small grid), and the stage-2 batch
# (2 x 1280 rows), forward and transposed.
PREFILL_ROWS = 900
SHORT_PREFILL_ROWS = 74
INT8_GEMM_CASES = [
    ("unet640_qkvo", 8192, 640, 640, False), ("unet640_geglu", 8192, 640, 5120, False),
    ("unet640_ff_out", 8192, 2560, 640, False), ("unet640_attn2_kv", 128, 2048, 640, False),
    ("unet1280_qkvo", 2048, 1280, 1280, False), ("unet1280_geglu", 2048, 1280, 10240, False),
    ("unet1280_ff_out", 2048, 5120, 1280, False), ("unet1280_attn2_kv", 128, 2048, 1280, False),
    ("prefill_qkvo", PREFILL_ROWS, 4096, 4096, False),
    ("prefill_gate_up", PREFILL_ROWS, 4096, 11008, False),
    ("prefill_down", PREFILL_ROWS, 11008, 4096, False),
    ("prefill74_qkvo", SHORT_PREFILL_ROWS, 4096, 4096, False),
    ("prefill74_gate_up", SHORT_PREFILL_ROWS, 4096, 11008, False),
    ("prefill74_down", SHORT_PREFILL_ROWS, 11008, 4096, False),
    ("train_qkvo", 2560, 4096, 4096, True), ("train_gate_up", 2560, 4096, 11008, True),
    ("train_down", 2560, 11008, 4096, True),
    # a --decode_tp 2 / 4 shard's prefill of the flagship's shortest prompt
    *((f"tp{tp}_prefill74_{name}", SHORT_PREFILL_ROWS, k, n, False) for tp in (2, 4)
      for name, k, n in (("qkv", 4096, 4096 // tp), ("o", 4096 // tp, 4096),
                         ("gate_up", 4096, 11008 // tp), ("down", 11008 // tp, 4096))),
]
# Launches of each UNet shape in one CFG step of SDXL-base: 10 transformer
# blocks and 5 Transformer2DModels at C = 640, 60 and 6 at C = 1280; a block
# runs q, k, v, out of attn1 and q, out of attn2 at (C, C), attn2's to_k /
# to_v from the context, the GEGLU projection and the output projection; a
# Transformer2DModel proj_in and proj_out.
UNET_STEP_COUNTS = {"unet640_qkvo": 6 * 10 + 2 * 5, "unet640_geglu": 10, "unet640_ff_out": 10,
                    "unet640_attn2_kv": 2 * 10, "unet1280_qkvo": 6 * 60 + 2 * 6,
                    "unet1280_geglu": 60, "unet1280_ff_out": 60, "unet1280_attn2_kv": 2 * 60}
# Small grids, where the launch plan matters most: each is also timed under
# the plans it did not take (block width, K slices on one block or a cluster).
INT8_GEMM_OPTIONS = ("unet640_attn2_kv", "unet1280_attn2_kv", "prefill74_qkvo",
                     "prefill74_gate_up", "prefill74_down", "unet1280_qkvo", "unet1280_ff_out")


def exact_transposed_int8(g, w, scale):
    """The transposed form as it is defined: bf16(bf16(g * bf16(scale)) W)
    with the product's sums in f32."""
    return ((g * scale.to(torch.bfloat16)).float() @ w.float()).to(torch.bfloat16)


def int8_gemm_row(name, m, n, k, a, w, scale, got, want, transposed) -> dict:
    """Errors of one form of kernel C against its exact plain version, its
    device ms, bound, the plain expression's ms and the library call's (on a
    bf16 copy of W, and for the transposed form a pre-scaled g, both made
    before the timer)."""
    err = (got.float() - want.float()).abs()
    row = dict(name=name, form="transposed" if transposed else "forward", shape=[m, n, k],
               max_abs=float(err.max()), max_rel=float(err.max() / want.float().abs().max()),
               mean_rel=float(err.mean() / want.float().abs().mean()),
               finite=bool(torch.isfinite(got).all()))
    if transposed:
        kernel = lambda: int8_gemm_kernel.transposed(a, w, scale)  # noqa: E731
        plain = lambda: torch.matmul(  # noqa: E731
            a * scale.to(torch.bfloat16), w.to(torch.bfloat16))
        w_bf16, a_lib = w.to(torch.bfloat16), a * scale.to(torch.bfloat16)
        library = lambda: torch.matmul(a_lib, w_bf16)  # noqa: E731
    else:
        kernel = lambda: int8_gemm_kernel(a, w, scale)  # noqa: E731
        plain = lambda: int8_linear(a, w, scale, implementation="plain")  # noqa: E731
        w_bf16 = w.to(torch.bfloat16)
        library = lambda: F.linear(a, w_bf16)  # noqa: E731
    iters = 20 if m * n * k >= 1 << 33 else 50
    t = [_time_ms(fn, iters) for fn in (plain, kernel, kernel, plain)]
    row["call_ms"], row["plain_ms"] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
    row["ms"], row["recorded"] = _profiled_ms(kernel, iters, ("int8_gemm_kernel",))[
        "int8_gemm_kernel"]
    flops, nbytes = 2 * m * n * k, n * k + 2 * m * k + 2 * m * n
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes)
    row["roofline"] = row["bound_ms"] / row["ms"]
    row["tflops"] = flops / row["ms"] / 1e9
    row["library_ms"] = _profiled_ms(library, iters)["all"][0]
    row["library"] = ("torch.matmul(g * bf16(scale), W_bf16)" if transposed
                      else "F.linear(x, W_bf16)")
    row["vs_library"] = row["ms"] / row["library_ms"]
    row["plan"] = list(int8_gemm_kernel.launch_plan(a.device, m, n, k, transposed))
    if name in INT8_GEMM_OPTIONS:
        row["options"] = int8_gemm_options(m, n, k, a, w, scale, transposed, row["plan"], iters)
    return row


def int8_gemm_options(m, n, k, a, w, scale, transposed, chosen, iters) -> list:
    """Device ms of kernel C under the launch plans it did not take: the other
    block width, and K slices on one block or on a cluster (an order of sums
    the kernel never mixes with another for one N and K; timed only here)."""
    cols, stages = (k, n // 64) if transposed else (n, k // 64)
    per_slice = chosen[1]
    plans = [(128, per_slice, False), (128, stages, False)]
    if per_slice < stages:
        plans.append((128, per_slice, True))
    if cols % 256 == 0:
        plans += [(256, per_slice, per_slice < stages), (256, stages, False)]
    out = []
    for plan in dict.fromkeys(plans):
        if list(plan) == chosen:
            continue
        ms, _ = _profiled_ms(lambda: int8_gemm_kernel._launch(a, w, scale, transposed, plan),
                             iters, ("int8_gemm_kernel",))["int8_gemm_kernel"]
        out.append({"plan": list(plan), "ms": ms})
    return out


def int8_gemm_sums(rows) -> dict:
    """Kernel C's forward times summed over a UNet CFG step and over a
    prefill of PREFILL_ROWS rows, each with its launches."""
    forward = {r["name"]: r for r in rows if r["form"] == "forward"}
    keys = ("ms", "bound_ms", "plain_ms", "library_ms")
    n_layers = LlamaConfig().num_hidden_layers
    return {
        "UNet CFG step": (sum(UNET_STEP_COUNTS.values()),
                          {key: sum(c * forward[s][key] for s, c in UNET_STEP_COUNTS.items())
                           for key in keys}),
        f"prefill of {PREFILL_ROWS} rows": (7 * n_layers, {
            key: n_layers * sum(PER_LAYER[s] * forward[f"prefill_{s}"][key] for s in PER_LAYER)
            for key in keys}),
    }


def phase_int8_gemm_kernel(label: str):
    """Kernel C against its exact plain version at every distinct shape of
    the int8 UNet, a flagship prefill and the quantize_base training step
    (the transposed form at the training shapes), within kernel A's limits;
    device ms, bound, the plain expression and the library yardstick. Then
    rows 0-3 of a 2048-row call against a 64-row call, bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, failed = [], []
    for name, m, k, n, with_transposed in INT8_GEMM_CASES:
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand(n, generator=gen, device="cuda") / (127 * k ** 0.5)
        forms = [(x, int8_gemm_kernel(x, w, scale), exact_plain_int8(x, w, scale), False)]
        if with_transposed:
            g = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
            forms.append((g, int8_gemm_kernel.transposed(g, w, scale),
                          exact_transposed_int8(g, w, scale), True))
        torch.cuda.synchronize()
        for a, got, want, transposed in forms:
            row = int8_gemm_row(name, m, n, k, a, w, scale, got, want, transposed)
            if (not row["finite"] or row["max_rel"] > INT8_MAX_REL
                    or row["mean_rel"] > INT8_MEAN_REL):
                failed.append(f"{name} ({row['form']})")
            print(f"int8_gemm {name} {row['form']}: {json.dumps(row)} [{label}]", flush=True)
            rows.append(row)
    for what, (launches, total) in int8_gemm_sums(rows).items():
        print(f"int8_gemm per {what}: {launches} launches, {json.dumps(total)} [{label}]",
              flush=True)
    x = torch.randn(2048, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(2048, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randint(-127, 128, (4096, 4096), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand(4096, generator=gen, device="cuda") / (127 * 64)
    equal = (torch.equal(int8_gemm_kernel(x, w, scale)[:4],
                         int8_gemm_kernel(x[:64].contiguous(), w, scale)[:4])
             and torch.equal(int8_gemm_kernel.transposed(g, w, scale)[:4],
                             int8_gemm_kernel.transposed(g[:64].contiguous(), w, scale)[:4]))
    print(f"int8_gemm: rows 0-3 of a 2048-row call bit-equal to a 64-row call (both forms): "
          f"{equal} [{label}]", flush=True)
    if not equal:
        failed.append("rows of a 2048-row call differ from a 64-row call")
    # the small grids: attn2's to_k at 128 rows (K slices on a cluster)
    # against 33 rows and against the 2048-row call (one block a tile)
    for n in (640, 1280):
        x = torch.randn(2048, 2048, generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randint(-127, 128, (n, 2048), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand(n, generator=gen, device="cuda") / (127 * 2048 ** 0.5)
        whole = int8_gemm_kernel(x, w, scale)
        equal = (torch.equal(int8_gemm_kernel(x[:128].contiguous(), w, scale), whole[:128])
                 and torch.equal(int8_gemm_kernel(x[:33].contiguous(), w, scale), whole[:33]))
        print(f"int8_gemm: (N, K) = ({n}, 2048) rows of 128- and 33-row calls (plans "
              f"{int8_gemm_kernel.launch_plan(x.device, 128, n, 2048, False)}) bit-equal to a "
              f"2048-row call ({int8_gemm_kernel.launch_plan(x.device, 2048, n, 2048, False)}): "
              f"{equal} [{label}]", flush=True)
        if not equal:
            failed.append(f"rows of ({n}, 2048) small-grid calls differ from a 2048-row call")
    if failed:
        raise AssertionError(f"int8_gemm disagrees with the plain version at {failed}")
    return rows


# The cache attention: (name, B, Hq, Hkv, S, C, int8 cache, kv_len). The
# story phase's bf16 cache, the flagship phase's int8 cache at the smoke's
# contexts and at the window-8 capacity (S = 1 decode, S = 5 verify), and
# GQA 4 with an empty row.
ATTN_CASES = [
    ("bf16_s1_c400", 1, 32, 32, 1, 400, False, None),
    ("bf16_s5_c400", 1, 32, 32, 5, 400, False, None),
    ("int8_s1_c900", 1, 32, 32, 1, 900, True, None),
    ("int8_s5_c900", 1, 32, 32, 5, 900, True, None),
    ("int8_s1_c5248", 1, 32, 32, 1, 5248, True, None),
    ("int8_s5_c5248", 1, 32, 32, 5, 5248, True, None),
    ("gqa4_empty_row_int8", 2, 32, 8, 5, 1100, True, [1100, 0]),
    ("gqa4_empty_row_bf16", 2, 32, 8, 1, 1100, False, [700, 0]),
    # a --decode_tp 2 / 4 shard: 16 / 8 of the 32 heads
    ("tp2_int8_s1_c900", 1, 16, 16, 1, 900, True, None),
    ("tp2_int8_s5_c900", 1, 16, 16, 5, 900, True, None),
    ("tp4_int8_s1_c900", 1, 8, 8, 1, 900, True, None),
    ("tp4_int8_s5_c900", 1, 8, 8, 5, 900, True, None),
    # the verify pass of 4 stories in lockstep, their contexts apart
    ("int8_s5_b4_unequal", 4, 32, 32, 5, 3600, True, [900, 1800, 2700, 3600]),
]


def phase_decode_attn_kernel(label: str):
    """Kernel B against its plain version on f32 copies of the inputs (the
    int8 cache as it is); device ms of the split-KV kernel and its merge,
    bound (bytes: the visible keys' K, V and scales, q and O once each), the
    plain version on the kernel's own inputs, and SDPA on a dequantized bf16
    cache with a boolean mask."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, failed = [], []
    for name, b, hq, hkv, s, c, int8, kv_len in ATTN_CASES:
        q = torch.randn(b, hq, s, 128, generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn(b, hkv, c, 128, generator=gen, device="cuda") for _ in range(2))
        ks = vs = None
        if int8:
            ks, vs = k.abs().amax(-1) / 127, v.abs().amax(-1) / 127
            k = torch.round(k / ks[..., None]).clamp(-127, 127).to(torch.int8)
            v = torch.round(v / vs[..., None]).clamp(-127, 127).to(torch.int8)
            kd = (k.float() * ks[..., None]).to(torch.bfloat16)
            vd = (v.float() * vs[..., None]).to(torch.bfloat16)
        else:
            k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
            kd, vd = k, v
        lens = torch.tensor(kv_len or [c] * b, dtype=torch.int32, device="cuda")
        starts = (lens - s).clamp(min=0).to(torch.int32)
        kw = dict(kv_len=lens, q_start=starts, k_scale=ks, v_scale=vs)
        out = decode_attention(q, k, v, implementation="kernel", **kw)
        torch.cuda.synchronize()
        f32 = (lambda t: t) if int8 else (lambda t: t.float())
        want = decode_attention(q.float(), f32(k), f32(v), implementation="plain", **kw)
        err = (out.float() - want).abs()
        row = dict(name=name, shape=[b, hq, hkv, s, c], int8=int8, o_max_abs=float(err.max()),
                   o_mean_abs=float(err.mean()))
        if row["o_max_abs"] > O_MAX_ABS or row["o_mean_abs"] > O_MEAN_ABS:
            failed.append(name)
        kernel = lambda: decode_attention(q, k, v, implementation="kernel", **kw)  # noqa: E731
        plain = lambda: decode_attention(q, k, v, implementation="plain", **kw)  # noqa: E731
        t = [_time_ms(fn, 50) for fn in (plain, kernel, kernel, plain)]
        row["call_ms"], row["plain_ms"] = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        row["ms"] = _profiled_ms(kernel, 50, ("decode_attn_chunk_kernel",))["all"][0]
        q_rows = (hq // hkv) * s
        row["chunks"] = decode_attn.chunking(q.device, b, hkv, c,
                                             -(-q_rows // decode_attn.ROW_TILE))[1]
        work = attention_work(b, hq, hkv, s, c, 128, True, starts.cpu(), lens.cpu())
        keys = work["kv"] // (2 * 128)  # (batch row, KV head, key) triples some row sees
        nbytes = 2 * keys * 128 * k.element_size() + (8 * keys if int8 else 0) + 2 * work["q"]
        row["bound_ms"], row["bound_by"] = bound(4 * 128 * work["pairs"], nbytes)
        row["roofline"] = row["bound_ms"] / row["ms"]
        row["library_ms"], row["library"] = time_library(q, kd, vd, 50, True, starts, lens)
        print(f"decode_attn {name}: {json.dumps(row)} [{label}]", flush=True)
        rows.append(row)
    if failed:
        raise AssertionError(f"decode_attn disagrees with the plain version at {failed}")
    return rows


# The attention probes (seed_story_torch/benchmarks/): each kernel against
# its plain version at the shapes of the JAX probes, then each probe's
# main(). The exp floor is a shape's exponentials over the SFU's rate: 16
# MUFU results a clock per multiprocessor (compute capability 9.0), 132
# multiprocessors, at the 1.83 GHz that the bf16 peak assumes.
EXP_PER_S = 16 * 132 * 1.83e9
PROBE_ATTN_SHAPES = ((2, 10, 4096, 64), (2, 20, 1024, 64))
PROBE_SP_SHAPES = ((2, 20, 1024, 64), (2, 10, 2048, 64))
PROBE_COPY_SHAPES = ((2, 20, 1024, 64), (2, 10, 2048, 64), (2, 10, 4096, 64), (2, 10, 1024, 128))
PROBE_ENTRY_POINTS = (probe_attn_variants, probe_attn_overhead, probe_attn_dma)
# Device ms of the kernels before their redesign, printed beside each row's
# ms: the single pass and the copy (one block a head) from this script's
# probes phase at commit a533027, the online kernel (mma.sync, cp.async) at
# commit bed7635 by (shape, variant, tile), both on an NVIDIA H100 80GB HBM3
# at 700.00 W, as PERF.md section 6 records them.
PROBE_BEFORE_MS = {
    ("probe_single_pass", (2, 20, 1024, 64)): 0.2536,
    ("probe_single_pass", (2, 10, 2048, 64)): 0.9749,
    ("probe_single_pass_fused_bh", (2, 20, 1024, 64)): 0.6019,
    ("probe_single_pass_fused_bh", (2, 10, 2048, 64)): 2.3149,
    ("probe_attn_packed2", (2, 20, 1024, 64)): 0.5562,
    ("probe_copy_only", (2, 20, 1024, 64)): 0.0069,
    ("probe_copy_only", (2, 10, 2048, 64)): 0.0119,
    ("probe_copy_only", (2, 10, 4096, 64)): 0.0512,
    ("probe_copy_only", (2, 10, 1024, 128)): 0.0119,
}
_ATTN_BEFORE_MS = {  # each variant's ms at probe_kernels.TILES, in order
    (2, 10, 4096, 64): {"base": (0.3974819, 0.3823419, 0.4067723, 0.4012261),
                        "exp2": (0.3736773, 0.3368480, 0.3431312, 0.3553359),
                        "noexp": (0.3358637, 0.3026540, 0.3475181, 0.3185004)},
    (2, 20, 1024, 64): {"base": (0.0665539, 0.0644875, 0.0583639, 0.0589513),
                        "exp2": (0.0604996, 0.0581252, 0.0502995, 0.0535764),
                        "noexp": (0.0559942, 0.0538238, 0.0524358, 0.0470811)},
}
PROBE_BEFORE_MS.update({("probe_attn", shape, variant, tile): ms
                        for shape, by_variant in _ATTN_BEFORE_MS.items()
                        for variant, row in by_variant.items()
                        for tile, ms in zip(probe_kernels.TILES, row)})
PROBE_SP_KERNELS = ("probe_single_pass", "probe_single_pass_fused_bh", "probe_attn_packed2")


def phase_probes(label: str):
    """Each probe kernel against its plain version on the same bf16 inputs
    at every probe shape (a second call bit-equal), with device ms
    (torch.profiler), the chained ``bench`` time of the whole call, the
    plain version's ms, the bound (4 S^2 d operations a head; Q, K, V and O
    once), the exp floor and one library call on the same inputs (SDPA;
    ``q + v`` for the copy); then the three probes' ``main()`` with the
    launch counts set to 0 just before and read just after. The online
    kernel's instances are first held against ``attn_plan``: the shared
    memory, stages, threads and blocks an SM that the card reports."""
    t0 = time.perf_counter()
    rows, failed, library = [], [], {}
    for variant in probe_kernels.VARIANTS:
        for tile in probe_kernels.TILES:
            inst = probe_kernels.attn_instance(variant, *tile)
            plan = probe_kernels.attn_plan(*PROBE_ATTN_SHAPES[0][:3], *tile,
                                           probe_kernels._sms(0))
            print(f"probe_attn instance {variant} {tile}: {json.dumps(inst)} [{label}]", flush=True)
            if any(inst[k] != getattr(plan, k)
                   for k in ("smem_bytes", "stages", "threads", "blocks_per_sm")):
                failed.append(f"probe_attn {variant} {tile}: the card reports {inst}, "
                              f"attn_plan says {plan}")

    def measure(name, shape, f, plain, tensors, exps, **fields):
        q, k, v = tensors
        attention = name != "probe_copy_only"
        got, again = f(q, k, v), f(q, k, v)
        torch.cuda.synchronize()
        want = plain(q, k, v)
        row = dict(kernel=name, shape=list(shape), **fields)
        if not torch.equal(got, again):
            failed.append(f"{name} {shape} {fields}: a second call differs")
        if not attention:
            row["bitwise"] = torch.equal(got, want)
            row["o_max_abs"] = float((got.float() - want.float()).abs().max())
            ok = row["bitwise"]
        elif fields.get("variant") == "noexp":
            row["noexp_conditioned"] = probe_kernels.noexp_error(q, k, got, want)
            ok = row["noexp_conditioned"] <= O_MAX_ABS and bool(torch.isfinite(got.float()).all())
        else:
            err = (got.float() - want.float()).abs()
            row["o_max_abs"], row["o_mean_abs"] = float(err.max()), float(err.mean())
            ok = row["o_max_abs"] <= O_MAX_ABS and row["o_mean_abs"] <= O_MEAN_ABS
        if not ok:
            failed.append(f"{name} {shape} {fields}")
        del got, again, want
        iters = 10 if q.shape[2] >= 4096 else 20
        row["ms"], row["recorded"] = _profiled_ms(lambda: f(q, k, v), iters, ("probe_",))["probe_"]
        key = (name, tuple(shape))
        if name == "probe_attn":
            key += (fields["variant"], (fields["block_q"], fields["block_kv"]))
        row["before_ms"] = PROBE_BEFORE_MS.get(key)
        row["plan"] = getattr(probe_kernels, name).last_plan._asdict()  # as launched
        row["bench_ms"] = 1e3 * bench(f, q, k, v)
        row["plain_ms"] = _time_ms(lambda: plain(q, k, v), 3)
        b, h, s, d = q.shape
        row["bound_ms"], row["bound_by"] = bound(4 * b * h * s * s * d if attention else 0,
                                                 4 * q.numel() * q.element_size())
        row["roofline"] = row["bound_ms"] / row["ms"]
        row["exp_floor_ms"] = 1e3 * exps / EXP_PER_S if exps else None
        if attention:
            row["tflops"] = 4 * b * h * s * s * d / row["ms"] / 1e9
            if shape not in library:
                library[shape] = time_library(q, k, v, iters, False, None, None)
            row["library_ms"], row["library"] = library[shape]
        else:
            row["library_ms"] = _profiled_ms(lambda: q + v, iters)["all"][0]
            row["library"] = "q + v"
            # the same calls with the L2 flushed before each by reading 64
            # MiB (timed apart from the kernel): every input byte comes from
            # device memory, and the L2 holds no dirty line to write back
            flush = torch.ones(64 << 20, dtype=torch.uint8, device="cuda")

            def cold():
                flush.max()
                f(q, k, v)

            row["cold_ms"] = _profiled_ms(cold, iters, ("probe_",))["probe_"][0]
            row["cold_roofline"] = row["bound_ms"] / row["cold_ms"]
            del flush
        print(f"probe {name} {shape}: {json.dumps(row)} [{label}]", flush=True)
        rows.append(row)

    for shape in PROBE_ATTN_SHAPES:
        b, h, s, d = shape
        tensors = probe_qkv(shape, torch.device("cuda"))
        for variant in probe_kernels.VARIANTS:
            for bq, bkv in probe_kernels.TILES:
                kw = dict(variant=variant, block_q=bq, block_kv=bkv)
                measure("probe_attn", shape,
                        lambda q, k, v, kw=kw: probe_kernels.attn(q, k, v, implementation="kernel",
                                                                  **kw),
                        lambda q, k, v, kw=kw: probe_kernels.attn(q, k, v, implementation="plain",
                                                                  **kw),
                        tensors, 0 if variant == "noexp" else b * h * s * s, **kw)
        del tensors
        # what the exponentials cost the online kernel at each tile
        for bq, bkv in probe_kernels.TILES:
            ms = {r["variant"]: r["ms"] for r in rows if r["kernel"] == "probe_attn"
                  and tuple(r["shape"]) == shape and (r["block_q"], r["block_kv"]) == (bq, bkv)}
            cost = {"exp2_minus_noexp_ms": ms["exp2"] - ms["noexp"],
                    "base_minus_exp2_ms": ms["base"] - ms["exp2"],
                    "exp_floor_ms": 1e3 * b * h * s * s / EXP_PER_S}
            print(f"probe attn exp cost {shape} ({bq}, {bkv}): {json.dumps(cost)} [{label}]",
                  flush=True)
    for name in PROBE_SP_KERNELS:
        fn = getattr(probe_kernels, name.removeprefix("probe_"))
        for shape in PROBE_SP_SHAPES:
            b, h, s, d = shape
            measure(name, shape, lambda q, k, v: fn(q, k, v, implementation="kernel"),
                    lambda q, k, v: fn(q, k, v, implementation="plain"),
                    probe_qkv(shape, torch.device("cuda")), b * h * s * s)
    for shape in PROBE_COPY_SHAPES:
        measure("probe_copy_only", shape,
                lambda q, k, v: probe_kernels.copy_only(q, k, v, implementation="kernel"),
                lambda q, k, v: probe_kernels.copy_only(q, k, v, implementation="plain"),
                probe_qkv(shape, torch.device("cuda")), 0)
    gc.collect()
    torch.cuda.empty_cache()
    checked_s = time.perf_counter() - t0

    for kernel in probe_kernels.KERNELS:
        kernel.launches = 0
    results = {m.__name__.rpartition(".")[2]: m.main() for m in PROBE_ENTRY_POINTS}
    launches = {kernel.name: kernel.launches for kernel in probe_kernels.KERNELS}
    torch.cuda.empty_cache()
    print(f"probes main-path launches: {json.dumps(launches)} [{label}]", flush=True)
    failed += [f"{name}: not launched by the probes' main()"
               for name, n in launches.items() if n == 0]
    for probe, out in results.items():
        failed += [f"{probe} {r}" for r in out
                   if r.get("max_abs", 0.0) > O_MAX_ABS or not np.isfinite(r.get("ms", 0.0))]
    print(f"probes phase: {checked_s:.1f} s of checks and timing, "
          f"{time.perf_counter() - t0 - checked_s:.1f} s of the three main()s [{label}]",
          flush=True)
    failed += forbidden_imports()
    if failed:
        raise AssertionError(f"probes phase failed: {failed}")
    return rows, launches


# Cuts for time; widths and depths are the configs' own.
SEGMENTS, WINDOW = 3, 8
MAX_NEW = 160
FORCE_BOI_AT = MAX_NEW - 64 - 8
EULER_STEPS = 8
PIXELS = np.random.RandomState(0).randn(1, 3, 448, 448).astype(np.float32)
CAPTION = "george the monkey went to the park"


# The launch counts of the wrappers, by kernel.
LAUNCHES = {"flash_fwd": lambda: flash_fwd.launches,
            "int8_linear": lambda: int8_linear_kernel.launches,
            "int8_gemm": lambda: int8_gemm_kernel.launches,
            "decode_attn": lambda: decode_attn.launches}


class StageClock:
    """Times module calls (host clock around synchronized work) and counts
    the kernels' launches inside each, by stage name."""

    def __init__(self):
        self.calls = defaultdict(list)  # stage -> [(seconds, {kernel: launches})]
        self.last_inputs = {}  # stage -> (args, kwargs) of its last call, where kept
        self.handles = []

    def watch(self, module, stage_of, keep_inputs: bool = False):
        """Times ``module``'s calls; with ``keep_inputs`` it holds on to the
        last call's inputs (and the memory they pin)."""
        start = {}

        def before(mod, args, kwargs):
            torch.cuda.synchronize()
            if keep_inputs:
                self.last_inputs[stage_of(args, kwargs)] = (args, kwargs)
            start["t"] = time.perf_counter()
            start["n"] = {k: count() for k, count in LAUNCHES.items()}

        def after(mod, args, kwargs, out):
            torch.cuda.synchronize()
            self.calls[stage_of(args, kwargs)].append(
                (time.perf_counter() - start["t"],
                 {k: count() - start["n"][k] for k, count in LAUNCHES.items()}))

        self.handles += [module.register_forward_pre_hook(before, with_kwargs=True),
                         module.register_forward_hook(after, with_kwargs=True)]

    def close(self):
        for handle in self.handles:
            handle.remove()

    def launches(self, stage: str, kernel: str = "flash_fwd") -> int:
        return sum(n[kernel] for _, n in self.calls[stage])

    def total_s(self, stage: str) -> float:
        return sum(t for t, _ in self.calls[stage])

    def mean_ms(self, stage: str) -> float:
        return 1e3 * float(np.mean([t for t, _ in self.calls[stage]]))


def profile_call(module, args, kwargs) -> dict:
    """One more call of ``module`` on the inputs it last saw: its wall ms
    (synchronized), then, in a second call under torch.profiler, device ms
    of everything it launched, device ms and launches of the flash forward,
    and that call's wall ms (``profiled_wall_ms``, the profiler's overhead
    included)."""
    wall = []

    def run():
        t0 = time.perf_counter()
        module(*args, **kwargs)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    with torch.inference_mode():
        run()
        events = profiled(run, ("flash_fwd_kernel",))
    flash = [e for e in device_events(events) if "flash_fwd_kernel" in e.key]
    return {"wall_ms": 1e3 * wall[0], "profiled_wall_ms": 1e3 * wall[-1],
            "device_ms": sum(e.self_device_time_total for e in device_events(events)) / 1e3,
            "flash_ms": sum(e.self_device_time_total for e in flash) / 1e3,
            "flash_launches": sum(e.count for e in flash)}


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
    clock.watch(stack.image_pipe.adapter.unet, lambda a, k: "unet_cfg_step", keep_inputs=True)
    clock.watch(stack.image_pipe.vae.decoder, lambda a, k: "vae_decode")

    pipe = StoryGenerationPipeline(stack.tokenizer, stack.generator, stack.visual_encode,
                                   stack.detokenize, StoryPipelineConfig(
                                       story_len=SEGMENTS + 1, window_size=WINDOW,
                                       num_img_in_tokens=agent_cfg.num_img_in_tokens))
    torch.cuda.reset_peak_memory_stats()  # the story's own peak, not the kernel phases'
    flash_fwd.launches = flash_fwd.padded_copies = decode_attn.launches = 0
    segments, seg_s = [], []
    t_prev = time.perf_counter()
    for seg in pipe.run(PIXELS, CAPTION):
        torch.cuda.synchronize()
        seg_s.append(time.perf_counter() - t_prev)
        segments.append(seg)
        t_prev = time.perf_counter()
    launches, copies = flash_fwd.launches, flash_fwd.padded_copies
    attn_launches = decode_attn.launches
    clock.close()

    failures = []
    if copies:
        failures.append(f"{copies} inputs copied for TMA on the main path")
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
    n_layers = llm_cfg.num_hidden_layers
    if clock.launches("decode_token", "decode_attn") != n_layers * len(clock.calls["decode_token"]):
        failures.append(f"{clock.launches('decode_token', 'decode_attn')} decode attention "
                        f"launches in {len(clock.calls['decode_token'])} decode steps, expected "
                        f"{n_layers} a step")
    failures += forbidden_imports()

    for stage in ("vit_encode", "prefill", "decode_token", "unet_cfg_step", "vae_decode"):
        print(f"stage {stage}: {clock.mean_ms(stage):.3f} ms mean over "
              f"{len(clock.calls[stage])} calls, flash launches {clock.launches(stage)}, "
              f"decode_attn launches {clock.launches(stage, 'decode_attn')} [{label}]",
              flush=True)
    print(f"stage segment: {np.mean(seg_s):.3f} s/segment mean "
          f"({', '.join(f'{s:.3f}' for s in seg_s)}) [{label}]", flush=True)
    print(f"main path: {launches} flash launches, {attn_launches} decode_attn launches, "
          f"{copies} padded copies, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{label}]", flush=True)
    # after the counts are read: one more UNet CFG step, profiled (the
    # profiler's own overhead is in its wall time)
    unet = profile_call(stack.image_pipe.adapter.unet, *clock.last_inputs["unet_cfg_step"])
    print(f"unet_cfg_step profiled: {json.dumps(unet)} [{label}]", flush=True)
    if failures:
        raise AssertionError(f"story phase failed: {failures}")
    return {"flash_fwd": launches, "decode_attn": attn_launches}, stack


# The flagship phase: the JAX package's full preset decodes with int8
# weights, an int8 KV cache and prompt-lookup speculation (K = 4). Cuts as
# the story phase's, plus: run_sink for 4 segments and the visualization
# flow for 3 texts, both with window 2 so that images are evicted.
FLAGSHIP_K, FLAGSHIP_CAPACITY = 4, 1536
SINK_SEGMENTS, SINK_WINDOW = 4, 2
VIS_TEXTS = ("george found a red balloon in the park",
             "the balloon floated up over the tall trees",
             "george chased it all the way back home")
SINK_GROWTH_MAX = 28  # the first-4 block plus 12 + 12 tokens around the evicted image


def bf16_quantum(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7) if x else 2.0 ** -133


def drive(label: str, name: str, segments, agent, clocks: list, expect: int, images: bool):
    """Runs one flow to its end under a clock on the LLaMA (prefill: calls of
    more than 8 tokens; decode pass: the rest), checks its segments and
    prints its stage numbers. Every generate of the phase decodes MAX_NEW
    tokens (EOS banned), the first from its prefill."""
    clock = StageClock()
    clock.watch(agent.llm, lambda a, k: "prefill" if k["inputs_embeds"].shape[1] > 8
                else "decode_pass")
    clocks.append(clock)
    segs, seg_s = [], []
    t_prev = time.perf_counter()
    for seg in segments:
        torch.cuda.synchronize()
        seg_s.append(time.perf_counter() - t_prev)
        segs.append(seg)
        t_prev = time.perf_counter()
    clock.close()
    failures = [] if len(segs) == expect else [f"{name}: {len(segs)} segments, expected {expect}"]
    for seg in segs:
        if seg.image_features is None or not bool(torch.isfinite(seg.image_features).all()):
            failures.append(f"{name} segment {seg.index}: features missing or not finite")
        img = seg.image
        if images and (img is None or img.shape != (1024, 1024, 3) or img.min() == img.max()):
            failures.append(f"{name} segment {seg.index}: image missing or constant")
    passes, prefills = len(clock.calls["decode_pass"]), len(clock.calls["prefill"])
    tokens = prefills * (MAX_NEW - 1)
    stats = {"segments": len(segs), "s_per_segment": float(np.mean(seg_s)),
             "segment_s": seg_s, "prefill_ms": clock.mean_ms("prefill"), "prefills": prefills,
             "decode_passes": passes, "tokens_per_pass": tokens / passes,
             "decode_ms_per_token": 1e3 * clock.total_s("decode_pass") / tokens,
             "decode_ms_per_pass": clock.mean_ms("decode_pass"),
             "int8_gemm_per_prefill": clock.launches("prefill", "int8_gemm") / max(1, prefills),
             "context_tokens": [seg.context_tokens for seg in segs]}
    print(f"flagship {name}: {json.dumps(stats)} [{label}]", flush=True)
    return segs, stats, failures


def phase_flagship(label: str, stack):
    """The flagship decode configuration on the story phase's stack: the
    agent quantized in place (quantize_agent_: int8 weights, int8 KV cache),
    speculate_k = 4, through run, a speculative-against-greedy check, run_sink
    and the visualization flow. Kernel A must launch 224 times and kernel B
    32 times per decode pass, the flash forward and kernel C (224 times) in
    every prefill, with no input copied for TMA."""
    agent = stack.agent
    n_layers = agent.cfg.llm.num_hidden_layers
    t0 = time.perf_counter()
    quantize_agent_(agent, base=True, kv=True)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    n_int8 = sum(p.numel() for p in agent.parameters() if p.dtype == torch.int8)
    print(f"flagship: quantize_agent_ {time.perf_counter() - t0:.3f} s, {n_int8 / 1e9:.3f} B "
          f"int8 weights, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; "
          f"speculate_k={FLAGSHIP_K}, cache_capacity={FLAGSHIP_CAPACITY} [{label}]", flush=True)
    gcfg = dict(max_new_tokens=MAX_NEW, num_img_gen_tokens=agent.cfg.num_img_out_tokens,
                eos_token_id=-1, cache_capacity=FLAGSHIP_CAPACITY, force_boi_at=FORCE_BOI_AT)
    spec = StoryGenerator(agent, GenerateConfig(speculate_k=FLAGSHIP_K, **gcfg))
    n_in = agent.cfg.num_img_in_tokens
    story_cfg = dict(num_img_in_tokens=n_in)

    torch.cuda.reset_peak_memory_stats()
    for kernel in (flash_fwd, int8_linear_kernel, int8_gemm_kernel, decode_attn):
        kernel.launches = 0
    flash_fwd.padded_copies = 0
    clocks, failures, stats = [], [], {}

    pipe = StoryGenerationPipeline(stack.tokenizer, spec, stack.visual_encode, stack.detokenize,
                                   StoryPipelineConfig(story_len=SEGMENTS + 1, window_size=WINDOW,
                                                       **story_cfg))
    # the last verify pass and the last prefill of run: inputs, cache lengths before
    verify, prefill = [], []

    def keep_verify(mod, args, kwargs):
        rows = kwargs["inputs_embeds"].shape[1]
        if rows == FLAGSHIP_K + 1 or rows > 8:
            (verify if rows == FLAGSHIP_K + 1 else prefill)[:] = [
                args, kwargs, list(kwargs["cache"].length)]

    hook = agent.llm.register_forward_pre_hook(keep_verify, with_kwargs=True)
    _, stats["run"], fail = drive(label, "run", pipe.run(PIXELS, CAPTION), agent, clocks,
                                  SEGMENTS, images=True)
    hook.remove()
    failures += fail

    # speculation against plain greedy on the first segment's prompt
    prompt = CAPTION + image_comprehension_string(n_in)
    ids = np.asarray([stack.tokenizer.bos_token_id]
                     + stack.tokenizer.encode(prompt, add_special_tokens=False))
    ids_cmp = np.zeros(len(ids), bool)
    ids_cmp[-n_in - 1:-1] = True
    feats = stack.visual_encode(PIXELS)
    greedy = StoryGenerator(agent, GenerateConfig(speculate_k=0, **gcfg))
    plain_logits = []
    hook = agent.llm.register_forward_hook(
        lambda mod, args, kwargs, out: plain_logits.append(out["logits"][0, -1].float()),
        with_kwargs=True)
    clock = StageClock()
    clock.watch(agent.llm, lambda a, k: "prefill" if k["inputs_embeds"].shape[1] > 8
                else "decode_pass")
    clocks.append(clock)
    want = greedy.generate(ids, feats, np.ones((1,), bool), ids_cmp)["generate_ids"]
    hook.remove()
    greedy_ms = clock.mean_ms("decode_pass")
    greedy_passes = len(clock.calls["decode_pass"])
    got = spec.generate(ids, feats, np.ones((1,), bool), ids_cmp)["generate_ids"]
    clock.close()
    diff = np.flatnonzero(got != want)
    check = {"identical": not len(diff), "greedy_decode_ms_per_token": greedy_ms,
             "tokens": len(want)}
    if len(diff):
        i = int(diff[0])
        prev = torch.tensor([int(want[i - 1]) if i else int(ids[-1])], device=feats.device)
        top = torch.topk(greedy.automaton(prev, plain_logits[i][None])[0], 2).values.tolist()
        check.update(first_divergence=i, top2=top, gap=top[0] - top[1],
                     bf16_quantum=bf16_quantum(top[0]))
        if not check["gap"] <= check["bf16_quantum"]:
            failures.append(f"speculation diverged from greedy at step {i} with a top-2 gap "
                            f"{check['gap']} above one bf16 quantum {check['bf16_quantum']}")
    print(f"flagship spec_vs_greedy: {json.dumps(check)} [{label}]", flush=True)
    stats["spec_vs_greedy"] = check
    del plain_logits

    sink_pipe = StoryGenerationPipeline(
        stack.tokenizer, spec, stack.visual_encode, stack.detokenize,
        StoryPipelineConfig(story_len=SINK_SEGMENTS + 1, window_size=SINK_WINDOW, **story_cfg))
    segs, stats["run_sink"], fail = drive(label, "run_sink", sink_pipe.run_sink(PIXELS, CAPTION),
                                          agent, clocks, SINK_SEGMENTS, images=True)
    failures += fail
    vis_pipe = StoryVisualizationPipeline(
        stack.tokenizer, spec, stack.visual_encode, None,
        VisPipelineConfig(window_size=SINK_WINDOW, **story_cfg))
    vis_segs, stats["visualization"], fail = drive(
        label, "visualization", vis_pipe.run(PIXELS, CAPTION, list(VIS_TEXTS)), agent, clocks,
        len(VIS_TEXTS), images=False)
    failures += fail
    for name, mgr, at_least, flow_segs in (("run_sink", sink_pipe.sink, 2, segs),
                                           ("visualization", vis_pipe.sink, 1, vis_segs)):
        growth = np.diff([0] + mgr.sink_history).tolist()
        print(f"flagship {name} sink: {len(mgr.sink_history)} evictions, sink_len after each "
              f"{mgr.sink_history}, growth {growth} [{label}]", flush=True)
        if len(mgr.sink_history) < at_least:
            failures.append(f"{name}: {len(mgr.sink_history)} evictions, expected >= {at_least}")
        if any(g > SINK_GROWTH_MAX for g in growth):
            failures.append(f"{name}: sink grew by {growth} tokens per eviction")
        if max(seg.context_tokens for seg in flow_segs) > FLAGSHIP_CAPACITY:
            failures.append(f"{name}: context above the cache capacity")

    launches = {k: count() for k, count in LAUNCHES.items()}
    passes = sum(len(c.calls["decode_pass"]) for c in clocks)
    prefill_flash = sum(c.launches("prefill") for c in clocks)
    prefills = sum(len(c.calls["prefill"]) for c in clocks)
    prefill_gemm = sum(c.launches("prefill", "int8_gemm") for c in clocks)
    print(f"flagship launches: {json.dumps(launches)} in {passes} decode passes "
          f"({passes - greedy_passes} verify passes of {FLAGSHIP_K + 1} tokens, {greedy_passes} "
          f"greedy passes of 1); {prefills} prefills with {prefill_flash} flash and "
          f"{prefill_gemm} int8_gemm launches, "
          f"{flash_fwd.padded_copies} padded copies, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{label}]", flush=True)
    if prefill_gemm != 7 * n_layers * prefills or launches["int8_gemm"] != prefill_gemm:
        failures.append(f"{prefill_gemm} int8_gemm launches in {prefills} prefills "
                        f"({launches['int8_gemm']} in all), expected {7 * n_layers} a prefill "
                        f"and none elsewhere")
    if launches["int8_linear"] != 7 * n_layers * passes:
        failures.append(f"{launches['int8_linear']} int8_linear launches in {passes} decode "
                        f"passes, expected {7 * n_layers} a pass")
    if launches["decode_attn"] != n_layers * passes:
        failures.append(f"{launches['decode_attn']} decode_attn launches in {passes} decode "
                        f"passes, expected {n_layers} a pass")
    if prefill_flash == 0:
        failures.append("flash kernel not launched in prefill")
    if flash_fwd.padded_copies:
        failures.append(f"{flash_fwd.padded_copies} inputs copied for TMA")
    failures += forbidden_imports()
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # after the counts are read: run's last verify pass once more, profiled
    stats["verify_pass"] = profile_verify_pass(agent, *verify)
    print(f"flagship verify_pass profiled: {json.dumps(stats['verify_pass'])} [{label}]",
          flush=True)
    if (stats["verify_pass"]["int8_linear_launches"] != 7 * n_layers
            or stats["verify_pass"]["decode_attn_launches"] != n_layers):
        failures.append(f"profiled verify pass: {stats['verify_pass']}")
    # run's last prefill once more on kernel C, then on the plain product (a
    # bf16 copy of each weight, then cuBLAS), both profiled
    kernel_c = profile_verify_pass(agent, *prefill, names={"int8_gemm": "int8_gemm_kernel"})
    with plain_int8_products():
        plain = profile_verify_pass(agent, *prefill, names={})
    stats["prefill_profiled"] = {"rows": prefill[1]["inputs_embeds"].shape[1],
                                 "kernel_c": kernel_c, "plain": plain}
    print(f"flagship prefill profiled: {json.dumps(stats['prefill_profiled'])} [{label}]",
          flush=True)
    if failures:
        raise AssertionError(f"flagship phase failed: {failures}")
    return launches, stats


VERIFY_KERNELS = {"int8_linear": "int8_linear_kernel", "decode_attn": "decode_attn_chunk_kernel"}


def profile_verify_pass(agent, args, kwargs, lengths, names=VERIFY_KERNELS) -> dict:
    """One more verify pass (or prefill) of the LLaMA on the inputs it last
    saw, written at the cache position it had then: its wall ms without the
    profiler (synchronized), then, in a second run under torch.profiler, its
    device ms split into the kernels of ``names`` (kernels A and B) and the
    rest, with their launches, and that run's wall ms (``profiled_wall_ms``,
    the profiler's overhead included). The busy share is device ms over the
    unprofiled wall. The cache's lengths are put back afterwards."""
    cache = kwargs["cache"]
    after, wall = list(cache.length), []

    def run():
        cache.length = list(lengths)
        t0 = time.perf_counter()
        agent.llm(*args, **kwargs)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    with torch.inference_mode():
        run()
        events = device_events(profiled(run, tuple(names.values())))
    cache.length = after
    out = {"wall_ms": 1e3 * wall[0], "profiled_wall_ms": 1e3 * wall[-1],
           "device_ms": sum(e.self_device_time_total for e in events) / 1e3}
    for name, kernel in names.items():
        mine = [e for e in events if kernel in e.key]
        out[f"{name}_ms"] = sum(e.self_device_time_total for e in mine) / 1e3
        out[f"{name}_launches"] = sum(e.count for e in mine)
    out["rest_ms"] = out["device_ms"] - sum(out[f"{name}_ms"] for name in names)
    out["device_busy_share"] = out["device_ms"] / out["wall_ms"]
    return out


# The lockstep phase: B = 4 stories of the flagship configuration in
# lockstep through run_batch for LOCKSTEP_ROUNDS rounds (story_len one more),
# each against the same story run alone through run; then the serving phase
# on the same seeds.
LOCKSTEP_CAPTIONS = ("george the monkey went to the park",
                     "the man with the yellow hat baked a cake",
                     "george found a red kite on the beach",
                     "a parade marched through the city at night")
LOCKSTEP_PIXELS = [np.random.RandomState(10 + r).randn(1, 3, 448, 448).astype(np.float32)
                   for r in range(len(LOCKSTEP_CAPTIONS))]
LOCKSTEP_ROUNDS = 1  # depth cut so that the whole smoke stays near 600 s
IMAGE_MAX_ABS = 2  # served images against inline ones, in uint8 steps
# Where a lockstep story parts from the story alone, each pass's pick must be
# among the other pass's TOP_K candidates and within TIE_QUANTA bf16 quanta
# of that pass's top score. The two passes compute every row's products in
# other orders (cuBLAS at 4 (K + 1) rows against K + 1, the cache attention's
# chunks, the prefill at 4 prompts), and over 160 tokens those roundings
# drift further than the one quantum of a single pass: the flagship's
# speculative-against-greedy check keeps one.
TOP_K, TIE_QUANTA = 8, 2


class TopKRecorder:
    """Stands in for a generator's automaton: returns the same scores and
    keeps each call's previous tokens and the TOP_K scores and tokens of
    every row (on the device; read after the run)."""

    def __init__(self, automaton):
        self.automaton, self.calls = automaton, []

    def __getattr__(self, name):
        return getattr(self.automaton, name)

    def __call__(self, prev, scores):
        out = self.automaton(prev, scores)
        self.calls.append((prev, torch.topk(out, TOP_K)))
        return out


def recorded(generator, name: str, topk: TopKRecorder):
    """Wraps ``generator.<name>`` to keep each call's arguments, results and
    the automaton calls it made."""
    calls, fn = [], getattr(generator, name)

    def wrapped(*args, **kwargs):
        first = len(topk.calls)
        out = fn(*args, **kwargs)
        calls.append((args, out, topk.calls[first:]))
        return out

    setattr(generator, name, wrapped)
    return calls


def step_topk(auto_calls, gen_ids, rows: int, row: int, k: int, max_new: int) -> dict:
    """Decode step -> {token: score} of the TOP_K candidates of the pass that
    committed it, for row ``row`` of a speculative generate: the first
    automaton call is the prefill's pick (one row a story), each later one a
    (rows, K + 1) verify pass whose commits follow from the drafts and the
    tokens."""
    def at(top, j):
        return dict(zip(top.indices.view(-1, TOP_K)[j].tolist(),
                        top.values.view(-1, TOP_K)[j].tolist()))

    out = {0: at(auto_calls[0][1], row)}
    idx = 1
    for prev, top in auto_calls[1:]:
        if idx >= len(gen_ids):
            break
        drafts = prev.view(rows, k + 1)[row, 1:].tolist()
        accept = 0
        while (accept < k and idx + accept < len(gen_ids)
               and int(gen_ids[idx + accept]) == drafts[accept]):
            accept += 1
        for j in range(min(accept + 1, max_new - idx)):
            out[idx + j] = at(top, row * (k + 1) + j)
        idx += min(accept + 1, max_new - idx)
    return out


def lockstep_generator(agent):
    return StoryGenerator(agent, GenerateConfig(
        max_new_tokens=MAX_NEW, num_img_gen_tokens=agent.cfg.num_img_out_tokens, eos_token_id=-1,
        cache_capacity=FLAGSHIP_CAPACITY, force_boi_at=FORCE_BOI_AT, speculate_k=FLAGSHIP_K,
        return_cache=False))


def phase_lockstep(label: str, stack):
    """The flagship stack (int8 agent and cache, speculate_k = 4) serving 4
    stories in lockstep through run_batch, against each story alone through
    run. Kernel A must take every product of the (4, 5) verify pass (224
    launches a pass), kernel B 32 a pass, and the flash forward and kernel C
    (224 launches) the batched prefill."""
    agent = stack.agent
    n_layers, b = agent.cfg.llm.num_hidden_layers, len(LOCKSTEP_CAPTIONS)
    seeds = list(zip(LOCKSTEP_PIXELS, LOCKSTEP_CAPTIONS))
    story_cfg = StoryPipelineConfig(story_len=LOCKSTEP_ROUNDS + 1, window_size=WINDOW,
                                    num_img_in_tokens=agent.cfg.num_img_in_tokens)
    failures, stats = [], {}

    # each story alone (B = 1, the same generator configuration)
    alone_gen = lockstep_generator(agent)
    alone_topk = alone_gen.automaton = TopKRecorder(alone_gen.automaton)
    alone_calls = recorded(alone_gen, "generate", alone_topk)
    alone_pipe = StoryGenerationPipeline(stack.tokenizer, alone_gen, stack.visual_encode,
                                         stack.detokenize, story_cfg)
    clock = StageClock()
    clock.watch(agent.llm, lambda a, k: "prefill" if k["inputs_embeds"].shape[1] > 8
                else "decode_pass")
    alone = []
    t0 = time.perf_counter()
    for pixels, caption in seeds:
        alone.append(list(alone_pipe.run(pixels, caption)))
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    clock.close()
    alone_passes = len(clock.calls["decode_pass"])
    stats["alone"] = {"wall_s": alone_s, "segments": sum(map(len, alone)),
                      "decode_passes": alone_passes,
                      "decode_ms_per_pass": clock.mean_ms("decode_pass"),
                      "tokens_per_pass": len(alone_calls) * (MAX_NEW - 1) / alone_passes,
                      "prefill_ms": clock.mean_ms("prefill")}
    stats["alone"]["stories_segments_per_min"] = 60 * stats["alone"]["segments"] / alone_s

    # the 4 stories in lockstep, images inline
    gen = lockstep_generator(agent)
    topk = gen.automaton = TopKRecorder(gen.automaton)
    batch_calls = recorded(gen, "generate_batch", topk)
    pipe = StoryGenerationPipeline(stack.tokenizer, gen, stack.visual_encode, stack.detokenize,
                                   story_cfg)
    clock = StageClock()
    clock.watch(agent.llm, lambda a, k: (
        "prefill" if k["inputs_embeds"].shape[1] > 8
        else f"decode_pass_{tuple(k['inputs_embeds'].shape[:2])}"))
    torch.cuda.reset_peak_memory_stats()
    for kernel in (flash_fwd, int8_linear_kernel, int8_gemm_kernel, decode_attn):
        kernel.launches = 0
    rounds = []
    t0 = time.perf_counter()
    for round_segments in pipe.run_batch(seeds):
        rounds.append(round_segments)
    torch.cuda.synchronize()
    lock_s = time.perf_counter() - t0
    launches = {k: count() for k, count in LAUNCHES.items()}
    clock.close()
    pass_stages = [s for s in clock.calls if s.startswith("decode_pass")]
    stage = f"decode_pass_{(b, FLAGSHIP_K + 1)}"
    passes = len(clock.calls[stage])
    segments = [[r[i] for r in rounds if r[i] is not None] for i in range(b)]
    stats["lockstep"] = {
        "wall_s": lock_s, "rounds": len(rounds), "segments": sum(map(len, segments)),
        "decode_passes": passes, "decode_ms_per_pass": clock.mean_ms(stage),
        "tokens_per_pass_per_row": len(batch_calls) * (MAX_NEW - 1) / passes,
        "prefill_ms": clock.mean_ms("prefill"), "prefills": len(clock.calls["prefill"]),
        "int8_linear_per_pass": clock.launches(stage, "int8_linear") / passes,
        "decode_attn_per_pass": clock.launches(stage, "decode_attn") / passes,
        "prefill_flash_launches": clock.launches("prefill"),
        "prefill_int8_gemm_launches": clock.launches("prefill", "int8_gemm"),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    stats["lockstep"]["stories_segments_per_min"] = 60 * stats["lockstep"]["segments"] / lock_s
    stats["lockstep"]["tokens_per_s"] = (len(batch_calls) * b * (MAX_NEW - 1)
                                         / clock.total_s(stage))
    stats["alone"]["tokens_per_s"] = (len(alone_calls) * (MAX_NEW - 1)
                                      / (alone_passes * stats["alone"]["decode_ms_per_pass"] / 1e3))
    print(f"lockstep: {json.dumps(stats)} [{label}]", flush=True)

    if pass_stages != [stage]:
        failures.append(f"decode passes of shapes {pass_stages}, expected only {stage}")
    if stats["lockstep"]["int8_linear_per_pass"] != 7 * n_layers:
        failures.append(f"{stats['lockstep']['int8_linear_per_pass']} int8_linear launches a "
                        f"pass of {b * (FLAGSHIP_K + 1)} rows, expected {7 * n_layers} (every "
                        f"int8 product of the pass)")
    if stats["lockstep"]["decode_attn_per_pass"] != n_layers:
        failures.append(f"{stats['lockstep']['decode_attn_per_pass']} decode_attn launches a "
                        f"pass, expected {n_layers}")
    if stats["lockstep"]["prefill_flash_launches"] == 0:
        failures.append("flash kernel not launched in the batched prefill")
    prefills = stats["lockstep"]["prefills"]
    if (stats["lockstep"]["prefill_int8_gemm_launches"] != 7 * n_layers * prefills
            or launches["int8_gemm"] != 7 * n_layers * prefills):
        failures.append(f"{launches['int8_gemm']} int8_gemm launches in {prefills} batched "
                        f"prefills, expected {7 * n_layers} a prefill and none elsewhere")
    if len(batch_calls) != LOCKSTEP_ROUNDS or len(rounds) != LOCKSTEP_ROUNDS:
        failures.append(f"{len(batch_calls)} generate_batch calls, {len(rounds)} rounds, "
                        f"expected {LOCKSTEP_ROUNDS}")
    for r, segs in enumerate(segments):
        for seg in segs:
            img = seg.image
            if img is None or img.shape != (1024, 1024, 3) or img.min() == img.max():
                failures.append(f"story {r} segment {seg.index}: image missing or constant")
            if seg.image_features is None or not bool(torch.isfinite(seg.image_features).all()):
                failures.append(f"story {r} segment {seg.index}: features missing or not finite")

    # each story's tokens against the same story alone on the same inputs,
    # round by round: round 0 is the story's first round through run; a
    # later round's inputs hold the lockstep's own earlier features, so the
    # story alone is one generate on them. They may part at a near tie
    # (TOP_K, TIE_QUANTA); each pass's gap between the two picks is printed
    # in bf16 quanta, and whether the whole story through run gave the same
    # tokens.
    checks = []
    for r in range(b):
        for t in range(LOCKSTEP_ROUNDS):
            got = batch_calls[t][1][r]["generate_ids"]
            run_out = alone_calls[r * LOCKSTEP_ROUNDS + t][1]
            if t == 0:
                want_out, want_auto = run_out, alone_calls[r * LOCKSTEP_ROUNDS][2]
            else:
                story = batch_calls[t][0][0][r]
                alone_gen.generate(story["input_ids"], story["image_embeds"],
                                   story["embeds_cmp_mask"], story["ids_cmp_mask"])
                _, want_out, want_auto = alone_calls[-1]
            want = want_out["generate_ids"]
            feat_diff = float((batch_calls[t][1][r]["img_gen_feat"].float()
                               - want_out["img_gen_feat"].float()).abs().max())
            check = {"story": r, "round": t, "identical": bool(np.array_equal(got, want)),
                     "feat_max_abs_diff": feat_diff,
                     "identical_to_run": bool(np.array_equal(got, run_out["generate_ids"]))}
            if not check["identical"]:
                i = int(np.flatnonzero(got[:len(want)] != want[:len(got)])[0])
                a, l = int(want[i]), int(got[i])  # the picks alone and in lockstep
                alone = step_topk(want_auto, want, 1, 0, FLAGSHIP_K, MAX_NEW)[i]
                lock = step_topk(batch_calls[t][2], got, b, r, FLAGSHIP_K, MAX_NEW)[i]
                # each pass's gap between its own pick and the other's, in quanta
                quanta = [float((s[x] - s[y]) / bf16_quantum(s[x])) if y in s else None
                          for s, x, y in ((alone, a, l), (lock, l, a))]
                check.update(first_divergence=i, picks=[a, l], scores=[
                    [alone[a], alone.get(l)], [lock.get(a), lock[l]]], gap_quanta=quanta)
                check["within_one_quantum"] = all(q is not None and q <= 1 for q in quanta)
                if not all(q is not None and q <= TIE_QUANTA for q in quanta):
                    failures.append(f"story {r} round {t}: lockstep parted from the story "
                                    f"alone at step {i} (tokens {a} alone, {l} in lockstep) "
                                    f"at gaps of {quanta} bf16 quanta, not a near tie")
            checks.append(check)
    print(f"lockstep vs alone: {json.dumps(checks)} [{label}]", flush=True)
    texts_equal = sum(c["identical"] for c in checks)
    run_equal = sum(c["identical_to_run"] for c in checks)
    parted = [c for c in checks if not c["identical"]]
    print(f"lockstep summary: {texts_equal} of {len(checks)} story rounds token-identical to the "
          f"story alone on the same inputs ({run_equal} to the story through run); the others "
          f"part at near ties of {[c['gap_quanta'] for c in parted]} bf16 quanta "
          f"({sum(c['within_one_quantum'] for c in parted)} within one); "
          f"{stats['lockstep']['decode_ms_per_pass']:.3f} ms a (4, 5) pass against "
          f"{stats['alone']['decode_ms_per_pass']:.3f} ms a (1, 5) pass; "
          f"{stats['lockstep']['stories_segments_per_min']:.3f} against "
          f"{stats['alone']['stories_segments_per_min']:.3f} stories x segments per minute; peak "
          f"{stats['lockstep']['peak_gib']:.2f} GiB [{label}]", flush=True)
    failures += forbidden_imports()
    if failures:
        raise AssertionError(f"lockstep phase failed: {failures}")
    return launches, stats, segments


def phase_serving(label: str, stack, inline_segments, inline_s: float, devices=None):
    """The lockstep phase's 4 seeds through PipelinedStoryServer: decode on
    the default stream, one de-tokenizer replica on the same card (the
    stack's own UNet and VAE) on a CUDA stream of its own, or one on each of
    ``devices`` (``--detok_devices``: copies of the UNet and VAE on other
    cards; the four-card check passes cards 1-3). Texts must equal
    the inline run_batch's, images agree within 2/255, segments come out in
    per-story order. Launches are totals over the phase (two threads
    launch); decode passes are counted by a hook that does not synchronize."""
    agent = stack.agent
    n_layers, b = agent.cfg.llm.num_hidden_layers, len(LOCKSTEP_CAPTIONS)
    pipe = StoryGenerationPipeline(
        stack.tokenizer, lockstep_generator(agent), stack.visual_encode, None,
        StoryPipelineConfig(story_len=LOCKSTEP_ROUNDS + 1, window_size=WINDOW,
                            num_img_in_tokens=agent.cfg.num_img_in_tokens))
    pool = DetokenizerPool(stack.detok_factory, devices or [stack.device])
    server = PipelinedStoryServer(pipe, pool)
    passes = []
    hook = agent.llm.register_forward_pre_hook(
        lambda mod, args, kwargs: passes.append(kwargs["inputs_embeds"].shape[1] <= 8),
        with_kwargs=True)
    torch.cuda.synchronize()
    for kernel in (flash_fwd, int8_linear_kernel, int8_gemm_kernel, decode_attn):
        kernel.launches = 0
    order, t0 = [], time.perf_counter()
    try:
        for story_idx, seg in server.serve_stream(list(zip(LOCKSTEP_PIXELS, LOCKSTEP_CAPTIONS))):
            order.append((story_idx, seg))
        torch.cuda.synchronize()
    finally:
        hook.remove()
        pool.shutdown()
    serve_s = time.perf_counter() - t0
    launches = {k: count() for k, count in LAUNCHES.items()}
    n_passes = sum(passes)
    stats = {"serve_wall_s": serve_s, "inline_wall_s": inline_s,
             "speedup": inline_s / serve_s, **server.stats(),
             "decode_passes": n_passes, "prefills": len(passes) - n_passes,
             "launches": launches}
    print(f"serving: {json.dumps(stats)} [{label}]", flush=True)

    failures = []
    for r in range(b):
        got = [seg for i, seg in order if i == r]
        want = inline_segments[r]
        if [s.index for s in got] != sorted(s.index for s in got):
            failures.append(f"story {r}: segments out of order {[s.index for s in got]}")
        if [s.text for s in got] != [s.text for s in want]:
            failures.append(f"story {r}: served texts differ from run_batch's")
        for g, w in zip(got, want):
            if g.image is None or g.image.shape != w.image.shape:
                failures.append(f"story {r} segment {g.index}: image missing")
                continue
            diff = int(np.abs(g.image.astype(np.int16) - w.image.astype(np.int16)).max())
            print(f"serving story {r} segment {g.index}: image max abs diff {diff} [{label}]",
                  flush=True)
            if diff > IMAGE_MAX_ABS:
                failures.append(f"story {r} segment {g.index}: image differs by {diff}")
    if launches["int8_linear"] != 7 * n_layers * n_passes:
        failures.append(f"{launches['int8_linear']} int8_linear launches in {n_passes} decode "
                        f"passes, expected {7 * n_layers} a pass")
    if launches["decode_attn"] != n_layers * n_passes:
        failures.append(f"{launches['decode_attn']} decode_attn launches in {n_passes} decode "
                        f"passes, expected {n_layers} a pass")
    if launches["flash_fwd"] == 0:
        failures.append("flash kernel not launched while serving")
    n_prefills = len(passes) - n_passes
    if launches["int8_gemm"] != 7 * n_layers * n_prefills:
        failures.append(f"{launches['int8_gemm']} int8_gemm launches in {n_prefills} "
                        f"prefills, expected {7 * n_layers} a prefill")
    failures += forbidden_imports()
    if failures:
        raise AssertionError(f"serving phase failed: {failures}")
    return launches, stats


def unet_step(unet, args, kwargs) -> dict:
    """One CFG step of ``unet`` on these inputs: its wall ms (the mean of 3
    synchronized calls after one), then one call under torch.profiler: the
    device ms of everything and of kernel C, with its launches, and that
    call's wall ms (``profiled_wall_ms``); the peak GiB of the calls."""
    torch.cuda.reset_peak_memory_stats()
    wall = []

    def run():
        t0 = time.perf_counter()
        unet(*args, **kwargs)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    with torch.inference_mode():
        for _ in range(4):
            run()
        events = device_events(profiled(run))
    mine = [e for e in events if "int8_gemm_kernel" in e.key]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    out = {"wall_ms": 1e3 * float(np.mean(wall[1:4])), "profiled_wall_ms": 1e3 * wall[-1],
           "device_ms": device_ms, "busy": device_ms / (1e3 * float(np.mean(wall[1:4]))),
           "int8_gemm_ms": sum(e.self_device_time_total for e in mine) / 1e3,
           "int8_gemm_launches": sum(e.count for e in mine),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    largest = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    out["largest"] = [[e.key[:60], e.self_device_time_total / 1e3, e.count] for e in largest]
    return out


def phase_unet_int8(label: str, stack):
    """The int8 UNet (--sdxl_int8) on the story stack's adapter, after every
    phase that needs its bf16 UNet: one CFG step of the bf16 UNet timed
    (wall, profiled device ms, peak GiB), the UNet quantized in place
    (quantize_adapter_), the same step on the int8 UNet, which must launch
    kernel C once for each of its quantized linear layers (722 at SDXL-base),
    and on the int8 UNet with the plain int8 product; then one 8-step
    1024x1024 image through the stack's de-tokenizer. The int8 eps against
    the bf16 eps is reported (random weights carry no quality meaning);
    kernel C against the plain product is gated: finite, correlation >=
    0.999."""
    adapter = stack.image_pipe.adapter
    unet, dt = adapter.unet, adapter.cfg.unet.dtype
    feats = stack.visual_encode(PIXELS)
    neg = stack.visual_encode(np.zeros_like(PIXELS))
    gen = torch.Generator(device="cuda").manual_seed(5)
    with torch.inference_mode():
        prompt, pooled = adapter.encode_image_embeds(torch.cat([neg, feats]))
    lat = torch.randn(2, 128, 128, 4, generator=gen, device="cuda").to(dt)
    args = (lat, torch.full((2,), 500.0, device="cuda"), prompt)
    kwargs = dict(time_ids=torch.tensor([[1024.0, 1024.0, 0.0, 0.0, 1024.0, 1024.0]] * 2,
                                        device="cuda"), text_embeds=pooled)
    stats = {"bf16": unet_step(unet, args, kwargs)}
    with torch.inference_mode():
        eps_bf16 = unet(*args, **kwargs).float()
    before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    quantize_adapter_(adapter)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    quantize_s = time.perf_counter() - t0
    after = torch.cuda.memory_allocated() / 2**30
    n_linear = sum(isinstance(m, torch.nn.Linear) for _, m in quantized_modules(unet))
    n_conv = sum(isinstance(m, torch.nn.Conv2d) for _, m in quantized_modules(unet))
    n_int8 = sum(p.numel() for p in unet.parameters() if p.dtype == torch.int8)
    print(f"unet_int8: quantize_adapter_ {quantize_s:.3f} s, {n_int8 / 1e9:.3f} B int8 weights "
          f"in {n_linear} linear and {n_conv} conv layers; {before:.2f} -> {after:.2f} GiB "
          f"allocated [{label}]", flush=True)
    int8_gemm_kernel.launches = 0
    with torch.inference_mode():
        eps_int8 = unet(*args, **kwargs).float()
    torch.cuda.synchronize()
    step_launches = int8_gemm_kernel.launches
    stats["int8"] = unet_step(unet, args, kwargs)
    with torch.inference_mode(), plain_int8_products():
        eps_plain = unet(*args, **kwargs).float()

    def compare(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return {"rel_max": float((a - b).abs().max() / b.abs().max()),
                "corr": float(torch.corrcoef(torch.stack([a, b]))[0, 1])}

    stats["int8_vs_bf16"] = compare(eps_int8, eps_bf16)
    stats["kernel_vs_plain"] = compare(eps_int8, eps_plain)
    stats.update(allocated_gib_bf16=before, allocated_gib_int8=after, quantize_s=quantize_s,
                 int8_gemm_launches_per_step=step_launches, quantized_linear=n_linear,
                 quantized_conv=n_conv)
    int8_gemm_kernel.launches = 0
    t0 = time.perf_counter()
    image = stack.detokenize(feats)
    torch.cuda.synchronize()
    stats["image_s"] = time.perf_counter() - t0
    image_launches = int8_gemm_kernel.launches
    print(f"unet_int8: {json.dumps(stats)} [{label}]", flush=True)
    failures = []
    if step_launches != n_linear:
        failures.append(f"{step_launches} int8_gemm launches in a CFG step, expected "
                        f"{n_linear} (one for each quantized linear layer)")
    if image_launches != n_linear * EULER_STEPS:
        failures.append(f"{image_launches} int8_gemm launches in an image of {EULER_STEPS} "
                        f"steps, expected {n_linear * EULER_STEPS}")
    if not (bool(torch.isfinite(eps_int8).all()) and stats["kernel_vs_plain"]["corr"] >= 0.999):
        failures.append(f"int8 UNet on kernel C against the plain product: "
                        f"{stats['kernel_vs_plain']}")
    if image.shape != (1024, 1024, 3) or image.min() == image.max():
        failures.append(f"int8 UNet image {image.shape}, constant {image.min() == image.max()}")
    failures += forbidden_imports()
    if failures:
        raise AssertionError(f"unet_int8 phase failed: {failures}")
    return step_launches + image_launches, stats


# Stage 2 at full width: configs/clm_models/llama2chat7b_lora.yaml with the
# one-chip recipe's remat, ce_chunk_size and bf16 parameters,
# agent_7b_sft.yaml, qwen_vitg_448.yaml; the batch follows george_sft.yaml
# (max_length 1280) with 10 image slots per sample. Cut: 4 steps on one
# repeated synthetic batch, random weights.
TRAIN_STEPS, TRAIN_SEQ, TRAIN_IMAGES = 4, 1280, 10
TRAIN_CONTEXT = (4, 8)  # context images per sample; each also has one generated image
TRAIN_VALID = (1280, 1100)  # sample 1 is padded after 1100 tokens


def train_batch(agent_cfg: AgentConfig, seed: int = 0):
    """One stage-2 batch with the keys, shapes and dtypes the long-story
    datapipe yields after ``flatten_images``: 64 in-token slots per context
    image, 64 out-token slots per generated image, labels on the response
    (the last segment) only, unused image slots zero."""
    rng = np.random.RandomState(seed)
    b, s, m = len(TRAIN_CONTEXT), TRAIN_SEQ, TRAIN_IMAGES
    n_in, n_out = agent_cfg.num_img_in_tokens, agent_cfg.num_img_out_tokens
    ids = rng.randint(100, 32000, size=(b, s)).astype(np.int32)
    mask = np.zeros((b, s), np.int32)
    labels = np.full((b, s), -100, np.int32)
    ids_cmp, ids_gen = np.zeros((b, s), bool), np.zeros((b, s), bool)
    emb_cmp, emb_gen = np.zeros(b * m, bool), np.zeros(b * m, bool)
    for row, (n_ctx, valid) in enumerate(zip(TRAIN_CONTEXT, TRAIN_VALID)):
        pos = 8
        for i in range(n_ctx):
            ids_cmp[row, pos:pos + n_in] = True
            emb_cmp[row * m + i] = True
            pos += n_in + 40
        ids_gen[row, pos + 100:pos + 100 + n_out] = True
        emb_gen[row * m + n_ctx] = True
        mask[row, :valid] = 1
        labels[row, pos:valid] = ids[row, pos:valid]
        ids[row, valid:] = 0
    images = rng.randn(b * m, 3, 448, 448).astype(np.float32)
    images[~(emb_cmp | emb_gen)] = 0.0
    return {"input_ids": ids, "attention_mask": mask, "labels": labels, "images": images,
            "embeds_cmp_mask": emb_cmp, "embeds_gen_mask": emb_gen,
            "ids_cmp_mask": ids_cmp, "ids_gen_mask": ids_gen}


def phase_train(label: str, quantize_base: bool = False):
    """Stage-2 training at full width through ``run_training``; per-step
    times, peak memory and launches are the runner's own metrics. With
    ``quantize_base`` (the one-chip recipe's frozen int8 base): the filled
    agent is quantized in place, its int8 weights and scales must come out
    bit for bit unchanged, kernel C must run every base product (forward,
    the remat recompute and the transposed backward: 3 x 224 a step), and
    the first step's loss must agree with the same step on the plain int8
    product within 1e-2 x |loss|."""
    bf16 = torch.bfloat16
    name = "train_int8" if quantize_base else "train"
    vit_cfg = ViTConfig(param_dtype=bf16)
    llm_cfg = LlamaConfig(lora_rank=16, lora_alpha=32.0, lora_dropout=0.05, remat=True,
                          ce_chunk_size=256, param_dtype=bf16)
    agent_cfg = AgentConfig(llm=llm_cfg)
    n_layers = llm_cfg.num_hidden_layers
    print(f"{name} cuts: {TRAIN_STEPS} steps on one repeated synthetic batch "
          f"({len(TRAIN_CONTEXT)} x {TRAIN_SEQ} tokens, {len(TRAIN_CONTEXT) * TRAIN_IMAGES} "
          f"images of 448x448), random weights; widths and depths not cut", flush=True)
    print(f"device memory before the build: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated [{label}]", flush=True)

    t0 = time.perf_counter()
    vit = fill_module(VisionTransformerWithAttnPool, vit_cfg, "cuda", seed=0)
    vit.eval().requires_grad_(False)
    agent = fill_module(ContinuousLVLM, agent_cfg, "cuda", seed=1)
    if quantize_base:  # llama2chat7b_lora_onechip.yaml: the float agent quantized in place
        quantize_agent_(agent, base=True, kv=False)
        gc.collect()
        torch.cuda.empty_cache()
    mask = lora_trainable_mask(agent)
    mask = {k: v or k.startswith(("input_resampler.", "output_resampler.")) for k, v in mask.items()}
    torch.cuda.synchronize()
    params = dict(agent.named_parameters())
    n_agent = sum(p.numel() for p in params.values())
    n_train = sum(params[k].numel() for k, v in mask.items() if v)
    n_int8 = sum(p.numel() for p in params.values() if p.dtype == torch.int8)
    n_vit = sum(p.numel() for p in vit.parameters())
    print(f"{name} build: {time.perf_counter() - t0:.2f} s, agent {n_agent / 1e9:.3f} B "
          f"parameters ({n_train / 1e9:.3f} B trainable, {n_int8 / 1e9:.3f} B int8), ViT "
          f"{n_vit / 1e9:.3f} B frozen, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated [{label}]", flush=True)

    batch = train_batch(agent_cfg)
    if quantize_base:  # every int8 weight and scale
        frozen = {k: p for k, p in params.items()
                  if p.dtype == torch.int8 or k.endswith("weight_scale")}
    else:
        frozen = {"q_proj": agent.llm.model.layers[0].self_attn.q_proj.weight}
    # host copies, so that they do not count in the steps' peak memory
    frozen_before = {k: p.detach().to("cpu", copy=True) for k, p in frozen.items()}
    plain_loss = None
    if quantize_base:  # the first step's loss on the plain int8 product, before training
        agent.train()
        with torch.no_grad(), plain_int8_products():
            plain_loss = float(make_stage2_loss_fn(agent, vit)(
                to_device(batch, torch.device("cuda")), derive_seed(0, 0))[0])
    vit_clock = StageClock()
    vit_clock.watch(vit, lambda a, k: "vit_encode")

    def repeated():
        while True:
            yield batch

    with tempfile.TemporaryDirectory() as out:
        flash_fwd.launches = flash_bwd.dq_launches = flash_bwd.dkv_launches = 0
        flash_fwd.padded_copies = flash_bwd.padded_copies = int8_gemm_kernel.launches = 0
        t_run = time.perf_counter()
        run_training(RunnerArgs(output_dir=out, max_steps=TRAIN_STEPS, save_steps=10**9,
                                log_steps=1, seed=0),
                     TrainConfig(learning_rate=1e-3, warmup_steps=1, training_steps=TRAIN_STEPS),
                     agent, make_stage2_loss_fn(agent, vit), repeated(), trainable_mask=mask)
        run_s = time.perf_counter() - t_run
        launches = kernel_launch_counts()
        copies = flash_fwd.padded_copies + flash_bwd.padded_copies
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        ckpt_dir = os.path.join(out, str(TRAIN_STEPS))
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, n)) for n in os.listdir(ckpt_dir))

    failures = [f"{copies} inputs copied for TMA in training"] if copies else []
    steps = [m for m in logged if "loss" in m]
    ckpt_s = next(m for m in logged if "checkpoint_write_seconds" in m)
    losses = [m["loss"] for m in steps]
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        failures.append(f"losses {losses}")
    elif not losses[-1] < losses[0]:
        failures.append(f"the last loss is not below the first: {losses}")
    lora_b = [m.lora_B.weight for m in agent.modules() if isinstance(m, LoRADense) and m.lora_rank]
    if not all(bool((w != 0).any()) for w in lora_b):
        failures.append("a LoRA B stayed at zero")
    changed = [k for k, p in frozen.items()
               if not torch.equal(p.detach().cpu(), frozen_before[k])]
    if changed:
        failures.append(f"{len(changed)} frozen base weights or scales changed: {changed[:3]}")
    del frozen_before
    if plain_loss is not None:
        print(f"{name} first step's loss {losses[0]:.6f} on kernel C against {plain_loss:.6f} "
              f"on the plain int8 product [{label}]", flush=True)
        if not abs(losses[0] - plain_loss) <= 1e-2 * abs(plain_loss):
            failures.append(f"the first loss {losses[0]} differs from the plain product's "
                            f"{plain_loss} by more than 1e-2 of it")
    vit_calls = vit_clock.calls["vit_encode"]
    gemm_per_step = 3 * 7 * n_layers if quantize_base else 0
    for i, m in enumerate(steps):
        vit_s, vit_launches = vit_calls[i]
        vit_fwd = vit_launches["flash_fwd"]
        sec = m["step_seconds"]
        fwd, dq, dkv, gemm = (int(m[k]) for k in LAUNCH_COUNTS)
        print(f"{name} step {i + 1}: {sec:.3f} s, loss {losses[i]:.4f}, vit_encode "
              f"{1e3 * vit_s:.3f} ms, agent fwd+bwd {1e3 * (m['fwd_bwd_seconds'] - vit_s):.3f} "
              f"ms, optimizer {1e3 * m['update_seconds']:.3f} ms, "
              f"{len(TRAIN_CONTEXT) * TRAIN_SEQ / sec:.1f} tokens/s, launches fwd {fwd} "
              f"(ViT {vit_fwd}) dq {dq} dkv {dkv} int8_gemm {gemm}, peak {m['peak_gib']:.2f} "
              f"GiB [{label}]", flush=True)
        # each differentiated attention call: 32 LLaMA layers + 2 resamplers;
        # the forward also runs again for each rematerialized layer
        if dq != n_layers + 2 or dkv != n_layers + 2:
            failures.append(f"step {i + 1}: {dq} dq / {dkv} dk-dv launches, expected {n_layers + 2}")
        if fwd - vit_fwd != 2 * n_layers + 2:
            failures.append(f"step {i + 1}: {fwd - vit_fwd} agent forward launches, expected "
                            f"{2 * n_layers + 2} (remat recompute included)")
        if gemm != gemm_per_step:
            failures.append(f"step {i + 1}: {gemm} int8_gemm launches, expected {gemm_per_step}")
    steady = steps[1:]
    step_s = float(np.mean([m["step_seconds"] for m in steady]))
    stats = {"s_per_step": step_s, "tokens_per_s": len(TRAIN_CONTEXT) * TRAIN_SEQ / step_s,
             "peak_gib": max(m["peak_gib"] for m in steps), "int8_gemm_per_step": gemm_per_step}
    print(f"{name} steady (steps 2-{TRAIN_STEPS}): {json.dumps(stats)} [{label}]", flush=True)
    print(f"{name} run: {run_s:.3f} s for {TRAIN_STEPS} steps; final checkpoint "
          f"{ckpt_bytes / 2**30:.3f} GiB, host copy {ckpt_s['checkpoint_copy_seconds']:.3f} s "
          f"+ write {ckpt_s['checkpoint_write_seconds']:.3f} s; "
          f"launches fwd {launches[0]} dq {launches[1]} dkv {launches[2]} int8_gemm "
          f"{launches[3]}, {copies} padded copies [{label}]", flush=True)
    failures += forbidden_imports()
    if failures:
        raise AssertionError(f"{name} phase failed: {failures}")
    return launches, stats


# Stage 3 at full width: the models of scripts/adapt_storystream.sh
# (qwen_vitg_448.yaml, llama2chat7b_lora.yaml + agent_7b_sft.yaml, the SDXL
# VAE, detokenizer_sdxl_qwen_vit_pretrained.yaml's SDXLAdapter); the batch is
# the stage-2 batch with 1024x1024 targets (george_sdxl.yaml,
# sd_transform_1024.yaml). Cut: 4 steps of 2 accumulated microbatches (the
# script takes 4) on one repeated synthetic batch, random weights.
STAGE3_STEPS, STAGE3_ACCUM, SD_SIZE = 4, 2, 1024


def stage3_batch(agent_cfg: AgentConfig):
    """The stage-2 batch plus what ``sd_image_transform`` adds: seeded
    uniform [-1, 1] targets (B, 3, 1024, 1024) and their SDXL time_ids."""
    batch = train_batch(agent_cfg)
    b = len(TRAIN_CONTEXT)
    rng = np.random.RandomState(3)
    batch["sd_images"] = rng.uniform(-1.0, 1.0, (b, 3, SD_SIZE, SD_SIZE)).astype(np.float32)
    batch["time_ids"] = np.array([[SD_SIZE, SD_SIZE, 0, 0, SD_SIZE, SD_SIZE]] * b, np.int32)
    return batch


def profile_microbatch(loss_fn, micro, trainable) -> dict:
    """One more stage-3 microbatch (loss and backward, gradients dropped):
    its wall ms without the profiler, then under torch.profiler the device
    ms of everything it launched, of each flash kernel, and of the largest
    kernels, and the profiled run's own wall ms."""
    wall = []

    def run():
        t0 = time.perf_counter()
        loss_fn(micro, 0)[0].backward()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        for p in trainable:
            p.grad = None

    run()
    events = device_events(profiled(run, ("flash_bwd_dkv_kernel",)))
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    out = {"wall_ms": 1e3 * wall[0], "profiled_wall_ms": 1e3 * wall[-1], "device_ms": device_ms,
           "busy": device_ms / (1e3 * wall[0])}
    for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"):
        mine = [e for e in events if kernel in e.key]
        out[f"{kernel}_ms"] = sum(e.self_device_time_total for e in mine) / 1e3
        out[f"{kernel}_launches"] = sum(e.count for e in mine)
    largest = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    out["largest"] = [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in largest]
    return out


def phase_stage3(label: str):
    """Stage 3 at full width through ``run_training``: the frozen ViT, agent
    and VAE encoder under the loss, the SDXLAdapter's resampler and UNet
    ``to_k`` / ``to_v`` training, with the flash kernels' launches per step
    (the UNet's attentions forward and backward, the frozen towers forward)
    and frozen / trained weights checked."""
    bf16 = torch.bfloat16
    llm_cfg = LlamaConfig(lora_rank=16, lora_alpha=32.0, lora_dropout=0.05, param_dtype=bf16)
    agent_cfg = AgentConfig(llm=llm_cfg)
    b = len(TRAIN_CONTEXT)
    print(f"stage3 cuts: {STAGE3_STEPS} steps of {STAGE3_ACCUM} accumulated microbatches on "
          f"one repeated synthetic batch ({b} x {TRAIN_SEQ} tokens, {b * TRAIN_IMAGES} images "
          f"of 448x448, {b} targets of {SD_SIZE}x{SD_SIZE}), random weights; widths and "
          f"depths not cut", flush=True)
    print(f"device memory before the build: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated [{label}]", flush=True)
    t0 = time.perf_counter()
    vit = fill_module(VisionTransformerWithAttnPool, ViTConfig(param_dtype=bf16), "cuda", seed=0)
    agent = fill_module(ContinuousLVLM, agent_cfg, "cuda", seed=1)
    vae = fill_module(AutoencoderKL, VAEConfig(), "cuda", seed=2)
    for frozen_module in (vit, agent, vae):
        frozen_module.eval().requires_grad_(False)
    adapter = fill_module(SDXLAdapter, SDXLAdapterConfig(), "cuda", seed=3)
    mask = adapter_trainable_mask(adapter)
    torch.cuda.synchronize()
    params = dict(adapter.named_parameters())
    n_train = sum(params[k].numel() for k, m in mask.items() if m)
    n_kv = sum(params[k].numel() for k, m in mask.items() if m and k.startswith("unet."))
    sizes = {name: sum(p.numel() for p in m.parameters()) / 1e9
             for name, m in (("ViT", vit), ("agent", agent), ("VAE", vae), ("adapter", adapter))}
    print(f"stage3 build: {time.perf_counter() - t0:.2f} s; frozen ViT {sizes['ViT']:.3f} B, "
          f"agent {sizes['agent']:.3f} B (bf16), VAE {sizes['VAE']:.3f} B; adapter "
          f"{sizes['adapter']:.3f} B f32 ({n_train / 1e9:.4f} B trainable: UNet to_k/to_v "
          f"{n_kv / 1e9:.4f} B, resampler {(n_train - n_kv) / 1e9:.4f} B); "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated [{label}]", flush=True)

    unet = adapter.unet
    block0 = unet.down_blocks[1].attentions[0].transformer_blocks[0]
    frozen = {"vit block 0 in_proj": vit.transformer.resblocks[0].attn.in_proj.weight,
              "agent layer 0 q_proj": agent.llm.model.layers[0].self_attn.q_proj.weight,
              "vae encoder conv_in": vae.encoder.conv_in.weight,
              "unet attn1 to_q": block0.attn1.to_q.weight,
              "unet resnet conv1": unet.down_blocks[0].resnets[0].conv1.weight}
    trained = {"unet self-attention to_k": block0.attn1.to_k.weight,
               "unet cross-attention to_v": unet.mid_block.attentions[0]
               .transformer_blocks[9].attn2.to_v.weight,
               "resampler proj_in": adapter.resampler.proj_in.weight}
    before = {k: t.detach().clone() for k, t in {**frozen, **trained}.items()}
    n_unet_attn = sum(isinstance(m, CrossAttention) for m in unet.modules())
    # flash forward launches of one microbatch's frozen towers: the ViT's
    # layers and attention pool, the LLaMA's layers and both resamplers
    towers_fwd = vit.cfg.layers + 1 + llm_cfg.num_hidden_layers + 2
    clock = StageClock()
    clock.watch(vit, lambda a, k: "vit")
    clock.watch(agent, lambda a, k: "agent")
    clock.watch(vae.encoder, lambda a, k: "vae_encode")
    batch = stage3_batch(agent_cfg)

    def repeated():
        while True:
            yield batch

    with tempfile.TemporaryDirectory() as out:
        flash_fwd.launches = flash_bwd.dq_launches = flash_bwd.dkv_launches = 0
        flash_fwd.padded_copies = flash_bwd.padded_copies = 0
        t_run = time.perf_counter()
        loss_fn = make_stage3_loss_fn(adapter, agent, vae, vit)
        trainer = run_training(
            RunnerArgs(output_dir=out, max_steps=STAGE3_STEPS, save_steps=10**9, log_steps=1,
                       seed=0),
            TrainConfig(learning_rate=1e-4, warmup_steps=1, training_steps=STAGE3_STEPS,
                        grad_accum_steps=STAGE3_ACCUM),
            adapter, loss_fn, repeated(), trainable_mask=mask)
        run_s = time.perf_counter() - t_run
        launches = kernel_launch_counts()[:3]
        copies = flash_fwd.padded_copies + flash_bwd.padded_copies
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
    clock.close()
    trainable = list(trainer.params.values())
    del trainer  # its Adam moments

    failures = [f"{copies} inputs copied for TMA in stage 3"] if copies else []
    steps = [m for m in logged if "loss" in m]
    ckpt_s = next(m for m in logged if "checkpoint_write_seconds" in m)
    losses = [m["loss"] for m in steps]
    if len(losses) != STAGE3_STEPS or not np.all(np.isfinite(losses)):
        failures.append(f"losses {losses}")
    failures += [f"frozen {k} changed" for k, t in frozen.items() if not torch.equal(t, before[k])]
    failures += [f"trainable {k} did not change" for k, t in trained.items()
                 if torch.equal(t, before[k])]
    targets = b * STAGE3_ACCUM
    for i, m in enumerate(steps):
        micro = slice(STAGE3_ACCUM * i, STAGE3_ACCUM * (i + 1))
        stage_s = {name: sum(t for t, _ in clock.calls[name][micro])
                   for name in ("vit", "agent", "vae_encode")}
        adapter_s = m["fwd_bwd_seconds"] - sum(stage_s.values())
        fwd, dq, dkv, _ = (int(m[k]) for k in LAUNCH_COUNTS)
        print(f"stage3 step {i + 1}: {m['step_seconds']:.3f} s, loss {losses[i]:.5f}, "
              f"{targets / m['step_seconds']:.3f} SDXL targets/s; fwd+bwd "
              f"{m['fwd_bwd_seconds']:.3f} s (ViT {stage_s['vit']:.3f}, agent "
              f"{stage_s['agent']:.3f}, VAE encode {stage_s['vae_encode']:.3f}, adapter fwd+bwd "
              f"{adapter_s:.3f}), update {m['update_seconds']:.3f} s, grad_norm "
              f"{m['grad_norm']:.4g}, launches fwd {fwd} dq {dq} dkv {dkv}, peak "
              f"{m['peak_gib']:.2f} GiB [{label}]", flush=True)
        # every UNet attention runs forward, dq and dk/dv once a microbatch
        # (the first self-attention's q needs no gradient; dq runs there too)
        if dq != STAGE3_ACCUM * n_unet_attn or dkv != STAGE3_ACCUM * n_unet_attn:
            failures.append(f"step {i + 1}: {dq} dq / {dkv} dk-dv launches, expected "
                            f"{STAGE3_ACCUM * n_unet_attn}")
        if fwd != STAGE3_ACCUM * (n_unet_attn + towers_fwd):
            failures.append(f"step {i + 1}: {fwd} forward launches, expected "
                            f"{STAGE3_ACCUM * (n_unet_attn + towers_fwd)}")
    steady = steps[1:]
    step_s = float(np.mean([m["step_seconds"] for m in steady]))
    stats = {"s_per_step": step_s, "targets_per_s": targets / step_s,
             "fwd_bwd_s": float(np.mean([m["fwd_bwd_seconds"] for m in steady])),
             "update_s": float(np.mean([m["update_seconds"] for m in steady])),
             "peak_gib": max(m["peak_gib"] for m in steps)}
    print(f"stage3 steady (steps 2-{STAGE3_STEPS}): {json.dumps(stats)}; run {run_s:.3f} s; "
          f"final checkpoint host copy {ckpt_s['checkpoint_copy_seconds']:.3f} s + write "
          f"{ckpt_s['checkpoint_write_seconds']:.3f} s; {n_unet_attn} UNet attentions; "
          f"launches fwd {launches[0]} dq {launches[1]} dkv {launches[2]}, {copies} padded "
          f"copies [{label}]", flush=True)
    prof = profile_microbatch(loss_fn, to_device(batch, torch.device("cuda")), trainable)
    print(f"stage3 microbatch profiled: {json.dumps(prof)} [{label}]", flush=True)
    failures += forbidden_imports()
    if failures:
        raise AssertionError(f"stage3 phase failed: {failures}")
    return launches


def free_memory():
    """Gives the memory of a finished phase's modules back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def steady_steps(logged: list, n_steps: int, what: str) -> tuple:
    """The runner's logged steps, their losses (which must be finite) and
    the mean seconds of the steps after the first."""
    steps = [m for m in logged if "loss" in m]
    losses = [m["loss"] for m in steps]
    failures = [] if len(losses) == n_steps and np.all(np.isfinite(losses)) else [
        f"{what} losses {losses}"]
    return steps, losses, float(np.mean([m["step_seconds"] for m in steps[1:]])), failures


# Stage 1 at full width: train.main on a text-to-image workspace that this
# script writes (jsonl records and 448x448 jpgs, through build_t2i_datapipe),
# the frozen ViT-bigG of configs/visual_tokenizer/qwen_vitg_448.yaml and a VQ
# DiscreteModelDistill at the DiscreteConfig defaults (dim 4096, codebook
# 8192). Cut: 4 steps of 16 images, random weights, the tiny tokenizer.
STAGE1_STEPS, STAGE1_BATCH = 4, 16


def write_t2i_workspace(root: str) -> str:
    """STAGE1_BATCH * 2 seeded 448x448 jpgs with captions, the YAMLs of the
    stage-1 entry's flags; returns the configs' directory."""
    from PIL import Image

    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "data"))
    rng = np.random.RandomState(5)
    with open(os.path.join(root, "data", "t2i.jsonl"), "w") as f:
        for i in range(2 * STAGE1_BATCH):
            pixels = (rng.rand(448, 448, 3) * 255).astype(np.uint8)
            Image.fromarray(pixels).save(os.path.join(root, "images", f"{i}.jpg"))
            f.write(json.dumps({"image": f"{i}.jpg", "caption": f"george and the dog, scene {i}"})
                    + "\n")
    cfg = os.path.join(root, "configs")
    os.makedirs(cfg)
    with open(os.path.join(cfg, "discrete.yaml"), "w") as f:
        f.write("_target_: seed_story_tpu.models.discrete.DiscreteModelDistill\nuse_vq: true\n"
                "cfg:\n  _target_: seed_story_tpu.models.discrete.DiscreteConfig\n")
    with open(os.path.join(cfg, "t2i.yaml"), "w") as f:
        f.write("_target_: seed_story_tpu.data.builders.build_t2i_datapipe\n"
                f"data_dir: {root}/data\nimage_dir: {root}/images\nmax_length: 128\n"
                f"batch_size: {STAGE1_BATCH}\nmin_resolution: 180\ncycle_count: 100\n")
    return cfg


def phase_stage1(label: str):
    """``seed_story_torch.train.train.main`` at full width, as a user runs it:
    finite losses, the flash forward's launches a step (the frozen ViT's 48
    layers and its attention pool), the VQ codes of the trained model on the
    card against the f64 argmin of the same distances."""
    print(f"stage1 cuts: {STAGE1_STEPS} steps of {STAGE1_BATCH} images, random weights, the "
          f"tiny tokenizer; widths and depths not cut", flush=True)
    with tempfile.TemporaryDirectory() as root:
        cfg = write_t2i_workspace(root)
        out = os.path.join(root, "out")
        argv = ["--image_transform", "configs/processer/qwen_448_transform.yaml",
                "--tokenizer", "configs/tokenizer/tiny_tokenizer.yaml",
                "--visual_encoder", "configs/visual_tokenizer/qwen_vitg_448.yaml",
                "--discrete_model", os.path.join(cfg, "discrete.yaml"),
                "--train_dataset", os.path.join(cfg, "t2i.yaml"), "--output_dir", out,
                "--learning_rate", "1e-4", "--warmup_steps", "1",
                "--max_steps", str(STAGE1_STEPS), "--save_steps", "1000", "--log_steps", "1"]
        flash_fwd.launches = flash_fwd.padded_copies = 0
        t0 = time.perf_counter()
        trainer = stage1.main(argv)
        run_s = time.perf_counter() - t0
        launches, copies = flash_fwd.launches, flash_fwd.padded_copies
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
    model = trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    steps, losses, step_s, failures = steady_steps(logged, STAGE1_STEPS, "stage1")
    if copies:
        failures.append(f"{copies} inputs copied for TMA in stage 1")
    for i, m in enumerate(steps):
        if int(m["flash_fwd_launches"]) != 48 + 1:
            failures.append(f"stage1 step {i + 1}: {m['flash_fwd_launches']} flash launches, "
                            "expected 49 (the ViT's layers and its pool)")
        print(f"stage1 step {i + 1}: {m['step_seconds']:.3f} s, loss {m['loss']:.5f} (distill "
              f"{m['distill_loss']:.5f}, commit {m['commit_loss']:.5f}, codebook "
              f"{m['codebook_loss']:.5f}), {STAGE1_BATCH / m['step_seconds']:.2f} images/s, "
              f"peak {m['peak_gib']:.2f} GiB, flash launches {m['flash_fwd_launches']} [{label}]",
              flush=True)
    # the codes on the card (TF32 off in the distance product) against f64
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(STAGE1_BATCH * 256, model.cfg.dim, generator=gen, device="cuda")
    with torch.no_grad():
        codes = model.quantizer(x)[1]
        cb = model.quantizer.codebook.double()
        d64 = x.double().square().sum(-1, keepdim=True) - 2 * x.double() @ cb.T + cb.square().sum(-1)
        top2 = d64.topk(2, dim=-1, largest=False).values
    differ = codes != d64.argmin(-1)
    near_tie = (top2[:, 1] - top2[:, 0]) <= 1e-4 * top2[:, 0].abs()
    if bool((differ & ~near_tie).any()):
        failures.append(f"{int((differ & ~near_tie).sum())} VQ codes differ from the f64 argmin "
                        "away from a tie")
    stats = {"s_per_step": step_s, "images_per_s": STAGE1_BATCH / step_s,
             "peak_gib": max(m["peak_gib"] for m in steps), "losses": losses,
             "codes_differing_from_f64": int(differ.sum()), "rows": int(x.shape[0])}
    print(f"stage1 steady (steps 2-{STAGE1_STEPS}): {json.dumps(stats)}; run {run_s:.3f} s "
          f"(builds, data and the final checkpoint included); discrete model "
          f"{n_params / 1e6:.1f} M parameters; {launches} flash launches [{label}]", flush=True)
    failures += forbidden_imports()
    if failures:
        raise AssertionError(f"stage1 phase failed: {failures}")
    return launches


# The IP-Adapter at full width: IPAdapterConfig(image_embedding_dim=4096) (the
# SD-1.5 UNet, IPAResampler with 4 tokens, cross-attention width 768) on the
# port's ViT-bigG with attention pool through DiscreteModelIdentity, seeded
# (77, 768) text embeds, the SDXL VAE; 512x512, 30 Euler steps, guidance 7.5,
# B = 1, at scale 0.8 and 0. Random bf16 weights.
IPA_STEPS = 30


def phase_ipa(label: str):
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    vit = fill_module(VisionTransformerWithAttnPool, ViTConfig(param_dtype=bf16), "cuda",
                      seed=0).eval().requires_grad_(False)
    ip = fill_module(IPAdapterSD, IPAdapterConfig(unet=sd15_unet_config(param_dtype=bf16),
                                                  image_embedding_dim=4096),
                     "cuda", seed=7).eval().requires_grad_(False)
    vae = fill_module(AutoencoderKL, VAEConfig(param_dtype=bf16), "cuda",
                      seed=8).eval().requires_grad_(False)
    discrete = DiscreteModelIdentity()
    torch.cuda.synchronize()
    n_ip = sum(p.numel() for p in ip.parameters())
    print(f"ipa build: {time.perf_counter() - t0:.2f} s, IP-Adapter {n_ip / 1e9:.3f} B "
          f"parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated [{label}]",
          flush=True)

    def encode_text(prompts):
        return np.stack([np.random.RandomState(sum(map(ord, p)) % 1000).randn(77, 768)
                         for p in prompts]).astype(np.float32)

    pipe = IPAdapterSDPipeline(ip, vae, encode_text, visual_encode=vit,
                               encode_discrete=discrete.encode_image_embeds,
                               cfg=IPASampleConfig(num_inference_steps=IPA_STEPS))
    clock = StageClock()
    clock.watch(ip.unet, lambda a, k: "unet_cfg_step", keep_inputs=True)
    clock.watch(vae.decoder, lambda a, k: "vae_decode")
    clock.watch(vit, lambda a, k: "vit_encode")
    finite = []  # the decoded pixels, before they become uint8
    hook = vae.decoder.register_forward_hook(
        lambda m, a, out: finite.append(bool(torch.isfinite(out).all())))
    image = torch.from_numpy(PIXELS).cuda()
    failures, images, image_s = [], {}, {}
    torch.cuda.reset_peak_memory_stats()
    flash_fwd.launches = flash_fwd.padded_copies = 0
    for scale in (0.8, 0.0):
        t0 = time.perf_counter()
        images[scale] = pipe.generate(image, prompt="george flies a kite", scale=scale, seed=3)
        image_s[scale] = time.perf_counter() - t0
    launches, copies = flash_fwd.launches, flash_fwd.padded_copies
    peak = torch.cuda.max_memory_allocated() / 2**30
    clock.close()
    hook.remove()
    if finite != [True, True]:
        failures.append(f"decoded pixels finite: {finite}")
    # per image: 2 ViT calls (the image and the zero negative) and 32
    # attentions (16 transformer blocks) in each of the 30 CFG steps
    per_image = 2 * (vit.cfg.layers + 1) + IPA_STEPS * 32
    if launches != 2 * per_image:
        failures.append(f"{launches} flash launches, expected {2 * per_image}")
    if copies:
        failures.append(f"{copies} inputs copied for TMA")
    for scale, img in images.items():
        if img.shape != (1, 512, 512, 3) or img.dtype != np.uint8 or img.min() == img.max():
            failures.append(f"scale {scale}: image {img.shape} {img.dtype} constant or wrong")
    differ = float(np.abs(images[0.8].astype(int) - images[0.0].astype(int)).mean())
    if differ == 0.0:
        failures.append("the images at scale 0.8 and 0 are the same")
    unet = profile_call(ip.unet, *clock.last_inputs["unet_cfg_step"])
    stats = {"s_per_image": image_s, "unet_cfg_step_ms": clock.mean_ms("unet_cfg_step"),
             "unet_cfg_step_device_ms": unet["device_ms"], "unet_flash_ms": unet["flash_ms"],
             "vae_ms": clock.mean_ms("vae_decode"), "vit_ms": clock.mean_ms("vit_encode"),
             "peak_gib": peak, "mean_abs_pixel_difference_of_the_scales": differ}
    print(f"ipa: {json.dumps(stats)}; {launches} flash launches ({per_image} an image), "
          f"{copies} padded copies; unet_cfg_step profiled {json.dumps(unet)} [{label}]",
          flush=True)
    failures += forbidden_imports()
    if failures:
        raise AssertionError(f"ipa phase failed: {failures}")
    return launches


# The SD-2.1 edit adapter at full width: SD21Text2ImageAndEditAdapter's
# default config (resampler=None) at 768x768 (8-channel 96x96 latents), B =
# 2, seeded text embeds (77 x 1024), trained under sd21_edit_trainable_mask.
# Cut: 3 steps on one repeated synthetic batch, random weights.
SD21_STEPS, SD21_SIZE = 3, 768


def phase_sd21_edit(label: str):
    t0 = time.perf_counter()
    model = fill_module(SD21Text2ImageAndEditAdapter, SD21EditAdapterConfig(), "cuda", seed=9)
    mask = sd21_edit_trainable_mask(model)
    params = dict(model.named_parameters())
    n_train = sum(params[k].numel() for k, m in mask.items() if m)
    n_attn = sum(isinstance(m, CrossAttention) for m in model.unet.modules())
    print(f"sd21_edit cuts: {SD21_STEPS} steps on one repeated synthetic batch of 2 at "
          f"{SD21_SIZE}x{SD21_SIZE}, random weights; build {time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in params.values()) / 1e9:.3f} B parameters "
          f"({n_train / 1e9:.3f} B trainable), {n_attn} attentions [{label}]", flush=True)
    rng = np.random.RandomState(4)
    lat = SD21_SIZE // 8
    batch = {"noisy_latents": rng.randn(2, lat, lat, 8).astype(np.float32),
             "timesteps": np.array([500, 20], np.int32),
             "text_embeds": rng.randn(2, 77, 1024).astype(np.float32),
             "noise": rng.randn(2, lat, lat, 4).astype(np.float32)}
    frozen = model.unet.down_blocks[0].resnets[0].conv1.weight
    trained = model.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn2.to_q.weight
    before = {"frozen": frozen.detach().clone(), "trained": trained.detach().clone()}

    def loss_fn(b, dropout_seed):
        out = model(b["noisy_latents"], b["timesteps"], None, b["text_embeds"], b["noise"])
        return out["total_loss"], {}

    def repeated():
        while True:
            yield batch

    with tempfile.TemporaryDirectory() as out:
        flash_fwd.launches = flash_bwd.dq_launches = flash_bwd.dkv_launches = 0
        flash_fwd.padded_copies = flash_bwd.padded_copies = 0
        run_training(RunnerArgs(output_dir=out, max_steps=SD21_STEPS, save_steps=10**9,
                                log_steps=1, seed=0),
                     TrainConfig(learning_rate=1e-5, warmup_steps=1, training_steps=SD21_STEPS),
                     model, loss_fn, repeated(), trainable_mask=mask)
        launches = kernel_launch_counts()[:3]
        copies = flash_fwd.padded_copies + flash_bwd.padded_copies
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
    steps, losses, step_s, failures = steady_steps(logged, SD21_STEPS, "sd21_edit")
    if copies:
        failures.append(f"{copies} inputs copied for TMA")
    if not torch.equal(frozen, before["frozen"]) or torch.equal(trained, before["trained"]):
        failures.append("a frozen weight changed or a trained one did not")
    for i, m in enumerate(steps):
        fwd, dq, dkv, _ = (int(m[k]) for k in LAUNCH_COUNTS)
        print(f"sd21_edit step {i + 1}: {m['step_seconds']:.3f} s, loss {m['loss']:.5f}, "
              f"grad_norm {m['grad_norm']:.4g}, launches fwd {fwd} dq {dq} dkv {dkv}, peak "
              f"{m['peak_gib']:.2f} GiB [{label}]", flush=True)
        if (fwd, dq, dkv) != (n_attn, n_attn, n_attn):
            failures.append(f"step {i + 1}: launches fwd {fwd} dq {dq} dkv {dkv}, expected "
                            f"{n_attn} each")
    stats = {"s_per_step": step_s, "peak_gib": max(m["peak_gib"] for m in steps),
             "losses": losses, "launches": launches}
    print(f"sd21_edit steady (steps 2-{SD21_STEPS}): {json.dumps(stats)} [{label}]", flush=True)
    failures += forbidden_imports()
    if failures:
        raise AssertionError(f"sd21_edit phase failed: {failures}")
    return launches


# The align agent at full width: SEEDLLaMAAlignGeneration over LLaMA-2-7B
# (configs/clm_models/llama2chat7b_lora.yaml, bf16 parameters) and the
# frozen ViT-bigG's features as targets, trained under align_trainable_mask
# on the stage-2 batch; then a text-seeded greedy story of 64 tokens with a
# bf16 cache. Cut: 3 steps, random weights.
ALIGN_STEPS, ALIGN_TOKENS = 3, 64


def phase_align(label: str):
    bf16 = torch.bfloat16
    llm_cfg = LlamaConfig(lora_rank=16, lora_alpha=32.0, lora_dropout=0.05, param_dtype=bf16)
    agent_cfg = AgentConfig(llm=llm_cfg)
    t0 = time.perf_counter()
    vit = fill_module(VisionTransformerWithAttnPool, ViTConfig(param_dtype=bf16), "cuda",
                      seed=0).eval().requires_grad_(False)
    agent = fill_module(SEEDLLaMAAlignGeneration, agent_cfg, "cuda", seed=1)
    mask = align_trainable_mask(agent)
    params = dict(agent.named_parameters())
    n_train = sum(params[k].numel() for k, m in mask.items() if m)
    print(f"align cuts: {ALIGN_STEPS} steps on one repeated synthetic stage-2 batch, random "
          f"weights; build {time.perf_counter() - t0:.2f} s, agent "
          f"{sum(p.numel() for p in params.values()) / 1e9:.3f} B parameters "
          f"({n_train / 1e6:.1f} M trainable) [{label}]", flush=True)
    batch = train_batch(agent_cfg)
    q_proj = agent.llm.model.layers[0].self_attn.q_proj.weight
    q_before = q_proj.detach().clone()

    def loss_fn(b, dropout_seed):
        with torch.no_grad():
            image_embeds = vit(b["images"])
        out = agent(input_ids=b["input_ids"], attention_mask=b["attention_mask"],
                    labels=b["labels"], image_embeds=image_embeds,
                    embeds_gen_mask=b["embeds_gen_mask"], embeds_cmp_mask=b["embeds_cmp_mask"],
                    ids_gen_mask=b["ids_gen_mask"], ids_cmp_mask=b["ids_cmp_mask"],
                    dropout_seed=dropout_seed)
        return out["total_loss"], {"rec_loss": out["rec_loss"].detach()}

    def repeated():
        while True:
            yield batch

    with tempfile.TemporaryDirectory() as out:
        flash_fwd.launches = flash_bwd.dq_launches = flash_bwd.dkv_launches = 0
        flash_fwd.padded_copies = flash_bwd.padded_copies = 0
        run_training(RunnerArgs(output_dir=out, max_steps=ALIGN_STEPS, save_steps=10**9,
                                log_steps=1, seed=0),
                     TrainConfig(learning_rate=1e-3, warmup_steps=1, training_steps=ALIGN_STEPS),
                     agent, loss_fn, repeated(), trainable_mask=mask)
        train_launches = kernel_launch_counts()[:3]
        copies = flash_fwd.padded_copies + flash_bwd.padded_copies
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
    steps, losses, step_s, failures = steady_steps(logged, ALIGN_STEPS, "align")
    if copies:
        failures.append(f"{copies} inputs copied for TMA")
    if not torch.equal(q_proj, q_before):
        failures.append("the frozen LLM changed")
    n_layers = llm_cfg.num_hidden_layers
    for i, m in enumerate(steps):
        fwd, dq, dkv, _ = (int(m[k]) for k in LAUNCH_COUNTS)
        print(f"align step {i + 1}: {m['step_seconds']:.3f} s, loss {m['loss']:.5f}, grad_norm "
              f"{m['grad_norm']:.4g}, launches fwd {fwd} dq {dq} dkv {dkv}, peak "
              f"{m['peak_gib']:.2f} GiB [{label}]", flush=True)
        # the ViT's 48 layers and pool, the LLaMA's layers, the output resampler
        if (fwd, dq, dkv) != (vit.cfg.layers + 1 + n_layers + 1, 1, 1):
            failures.append(f"align step {i + 1}: launches fwd {fwd} dq {dq} dkv {dkv}")
    del vit
    free_memory()

    agent.eval()
    generator = StoryGenerator(agent, GenerateConfig(
        max_new_tokens=ALIGN_TOKENS, num_img_gen_tokens=agent_cfg.num_img_out_tokens,
        eos_token_id=-1, cache_capacity=256))
    prompt = np.array([1] + [100 + 37 * i % 31000 for i in range(40)])
    no_image = np.zeros((1, agent_cfg.num_vit_tokens, agent_cfg.vit_dim), np.float32)
    args = (prompt, no_image, np.zeros(1, bool), np.zeros(len(prompt), bool))
    generator.generate(*args)  # warm-up
    flash_fwd.launches = decode_attn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generator.generate(*args)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    fwd, attn = flash_fwd.launches, decode_attn.launches
    if out["num_generated"] != ALIGN_TOKENS:
        failures.append(f"{out['num_generated']} tokens generated, expected {ALIGN_TOKENS}")
    if fwd != n_layers or attn != n_layers * (ALIGN_TOKENS - 1):
        failures.append(f"decode launches: flash {fwd} (prefill), decode_attn {attn}")
    stats = {"s_per_step": step_s, "peak_gib": max(m["peak_gib"] for m in steps),
             "losses": losses, "decode_ms_per_token": 1e3 * gen_s / out["num_generated"],
             "generate_s": gen_s}
    print(f"align: {json.dumps(stats)}; story flash launches {fwd}, decode_attn {attn} "
          f"[{label}]", flush=True)
    failures += forbidden_imports()
    if failures:
        raise AssertionError(f"align phase failed: {failures}")
    return train_launches, fwd, attn


def phase_vit_nopool(label: str):
    """One forward of the no-pool ViT-bigG at 448 (bf16 weights)."""
    vit = fill_module(VisionTransformer, ViTConfig(param_dtype=torch.bfloat16), "cuda",
                      seed=0).eval().requires_grad_(False)
    pixels = torch.from_numpy(PIXELS).cuda()
    with torch.inference_mode():
        vit(pixels)  # warm-up
        flash_fwd.launches = flash_fwd.padded_copies = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = vit(pixels)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    launches, copies = flash_fwd.launches, flash_fwd.padded_copies
    failures = []
    if feats.shape != (1, 1024, 1664) or not bool(torch.isfinite(feats).all()):
        failures.append(f"features {tuple(feats.shape)} or not finite")
    if launches != vit.cfg.layers or copies:
        failures.append(f"{launches} flash launches (expected {vit.cfg.layers}), {copies} copies")
    print(f"vit_nopool: {ms:.3f} ms a forward at 448, features {tuple(feats.shape)}, "
          f"{launches} flash launches [{label}]", flush=True)
    failures += forbidden_imports()
    if failures:
        raise AssertionError(f"vit_nopool phase failed: {failures}")
    return launches


# The kernels line's probe entries: (kernel, the TPU kernel it replaces, the
# row it reports: shape and, for the variants' kernel, variant and tiles).
# The parallel layer (parallel/*, decode/tensor_parallel.py). Stage 2 at
# full width (LLaMA-2-7B: 4096 hidden, 32 heads, 11008 MLP; ViT-bigG) with
# the LLaMA cut to WORLD1_LAYERS layers in world_of_one, so that its four
# trainers in turn fit the time (its checks are bit-equality, which more
# layers do not strengthen), and to PARALLEL_LAYERS in the four-card check.
PARALLEL_LAYERS, PARALLEL_STEPS = 8, 2
WORLD1_LAYERS = 4
RANK_LAYERS = 4  # each of the two ranks on the one card holds its own agent
TP_NEW = 64  # greedy tokens of the tensor-parallel decode check
CONVERTED_LAYERS = 2  # of LLaMA-2-7B's 32, at full width
CONVERTED_NEW = 64  # tokens the converted agent decodes
PEFT_NORMS = ("input_layernorm", "post_attention_layernorm", "norm")  # modules_to_save
# --decode_tp values it checks with every shard on the one card (tp = 4 runs
# on four cards in tools/multicard_check.py)
TP_DEGREES = (2,)


def parallel_agent_cfg(layers: int, quantize_base: bool = False) -> AgentConfig:
    return AgentConfig(llm=LlamaConfig(
        lora_rank=16, lora_alpha=32.0, lora_dropout=0.05, remat=True, ce_chunk_size=256,
        param_dtype=torch.bfloat16, num_hidden_layers=layers, quantize_base=quantize_base))


def stage2_mask(agent) -> dict:
    mask = lora_trainable_mask(agent)
    return {k: v or k.startswith(("input_resampler.", "output_resampler.")) for k, v in mask.items()}


def local_rows(batch: dict, index: int, count: int) -> dict:
    """Rows ``index`` of ``count`` equal parts of a stage-2 batch, each
    sample with its image slots."""
    b = batch["input_ids"].shape[0] // count
    n = batch["embeds_cmp_mask"].shape[0] // count
    per_image = ("images", "image_embeds", "embeds_cmp_mask", "embeds_gen_mask")
    return {k: v[(n if k in per_image else b) * index:(n if k in per_image else b) * (index + 1)]
            for k, v in batch.items()}


def start_world_of_one():
    """A process group of this process alone over NCCL (a tcp store on a
    free local port), as a one-card ``torchrun`` would start it."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    return dist


def timed_steps(trainer, batch, steps: int) -> list:
    """``steps`` trainer steps on ``batch``: (loss, grad_norm, seconds,
    peak GiB, launches (fwd, dq, dkv, int8_gemm)) each."""
    out = []
    for step in range(steps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = kernel_launch_counts()
        t0 = time.perf_counter()
        m = trainer.step(batch, derive_seed(0, step))
        torch.cuda.synchronize()
        out.append((float(m["loss"]), float(m["grad_norm"]), time.perf_counter() - t0,
                    torch.cuda.max_memory_allocated() / 2**30,
                    tuple(a - b for a, b in zip(kernel_launch_counts(), before))))
    return out


def phase_world_of_one(label: str):
    """A world of one rank over NCCL: the stage-2 steps of the unwrapped
    ``Trainer`` and of the ``dp`` and ``fsdp`` presets on a 1 x 1 mesh, from
    the same weights on the same batch: losses, grad norms and every trained
    parameter bit-equal. Then ``quantize_base`` under ``fsdp``: int8 weights
    and scales bit-equal after the steps, 3 x 7 kernel C launches a layer a
    step (forward, remat recompute, transposed backward)."""
    from seed_story_torch.parallel.mesh import make_mesh

    dist = start_world_of_one()
    cfg = parallel_agent_cfg(WORLD1_LAYERS)
    n = cfg.llm.num_hidden_layers
    print(f"parallel cuts: world of 1 over NCCL; LLaMA-2-7B width with {n} of 32 layers, "
          f"ViT-bigG whole; {PARALLEL_STEPS} steps a trainer on the train phase's batch "
          f"[{label}]", flush=True)
    vit = fill_module(VisionTransformerWithAttnPool, ViTConfig(param_dtype=torch.bfloat16),
                      "cuda", seed=0).eval().requires_grad_(False)
    batch = to_device(train_batch(cfg), torch.device("cuda"))
    initial = None
    runs, failures, launches = {}, [], [0, 0, 0, 0]
    for mode in (None, "dp", "fsdp"):
        agent = fill_module(ContinuousLVLM, cfg, "cuda", seed=1)
        if initial is None:
            initial = {k: v.clone() for k, v in agent.state_dict().items()}
        else:
            agent.load_state_dict(initial)
        mesh = None if mode is None else make_mesh(1, 1)
        trainer = Trainer(agent, make_stage2_loss_fn(agent, vit),
                          TrainConfig(learning_rate=1e-3, warmup_steps=0, training_steps=10,
                                      sharding_preset=mode or "fsdp"),
                          trainable_mask=stage2_mask(agent), mesh=mesh)
        steps = timed_steps(trainer, batch, PARALLEL_STEPS)
        params, _ = trainer.full_state()
        runs[mode] = (steps, params)
        for i, (loss, norm, sec, peak, counts) in enumerate(steps):
            print(f"parallel world1 {mode or 'unwrapped'} step {i + 1}: {sec:.3f} s, loss "
                  f"{loss:.6f}, grad_norm {norm:.6f}, peak {peak:.2f} GiB, launches fwd "
                  f"{counts[0]} dq {counts[1]} dkv {counts[2]} [{label}]", flush=True)
            if counts[1] != n + 2 or counts[2] != n + 2:
                failures.append(f"{mode} step {i + 1}: {counts[1]} dq / {counts[2]} dkv launches")
            if mode is not None:
                launches = [a + b for a, b in zip(launches, counts)]
        del trainer, agent
        free_memory()
    ref_steps, ref_params = runs[None]
    for mode in ("dp", "fsdp"):
        steps, params = runs[mode]
        same_losses = [a[:2] == b[:2] for a, b in zip(steps, ref_steps)]
        differ = [k for k in ref_params if not torch.equal(ref_params[k], params[k])]
        print(f"parallel world1 {mode} against unwrapped: losses and grad norms bit-equal "
              f"{all(same_losses)}, {len(differ)} of {len(ref_params)} parameters differ; "
              f"s/step {steps[-1][2]:.3f} against {ref_steps[-1][2]:.3f}, peak "
              f"{max(st[3] for st in steps):.2f} against {max(st[3] for st in ref_steps):.2f} "
              f"GiB [{label}]", flush=True)
        if not all(same_losses) or differ:
            failures.append(f"{mode}: losses equal {same_losses}, parameters differ {differ[:3]}")
    del runs, ref_params, initial
    free_memory()

    qcfg = parallel_agent_cfg(WORLD1_LAYERS)
    agent = fill_module(ContinuousLVLM, qcfg, "cuda", seed=1)
    quantize_agent_(agent, base=True, kv=False)
    frozen = {k: v.detach().clone() for k, v in agent.state_dict().items()
              if v.dtype == torch.int8 or k.endswith("weight_scale")}
    trainer = Trainer(agent, make_stage2_loss_fn(agent, vit),
                      TrainConfig(learning_rate=1e-3, warmup_steps=0, training_steps=10,
                                  sharding_preset="fsdp"),
                      trainable_mask=stage2_mask(agent), mesh=make_mesh(1, 1))
    steps = timed_steps(trainer, batch, PARALLEL_STEPS)
    params, _ = trainer.full_state()
    changed = [k for k, v in frozen.items() if not torch.equal(params[k].to(v.device), v)]
    for i, (loss, norm, sec, peak, counts) in enumerate(steps):
        print(f"parallel world1 fsdp quantize_base step {i + 1}: {sec:.3f} s, loss {loss:.6f}, "
              f"peak {peak:.2f} GiB, int8_gemm {counts[3]} launches (expected {3 * 7 * n}) "
              f"[{label}]", flush=True)
        if counts[3] != 3 * 7 * n or not np.isfinite(loss):
            failures.append(f"quantize_base step {i + 1}: {counts[3]} int8_gemm launches, "
                            f"loss {loss}")
        launches = [a + b for a, b in zip(launches, counts)]
    print(f"parallel world1 fsdp quantize_base: {len(frozen)} int8 weights and scales, "
          f"{len(changed)} changed [{label}]", flush=True)
    if changed:
        failures.append(f"quantize_base: {changed[:3]} changed")
    del trainer, agent, vit, params, frozen
    dist.destroy_process_group()
    free_memory()
    failures += forbidden_imports()
    if failures:
        raise AssertionError(f"parallel world-of-1 phase failed: {failures}")
    return launches


def phase_tp_decode(label: str, stack, degrees=None, devices=None):
    """``--decode_tp 2`` and ``--decode_tp 4`` on the story stack's int8
    agent (int8 KV cache), the one card standing in for every device: a copy
    of the agent decodes TP_NEW greedy tokens over the 1 x tp device mesh,
    beside the agent itself at tp = 1 on the same prompt. Tokens must agree,
    or part at a near tie (the lockstep rule: each pick among the other's
    top 8, within two bf16 quanta of its top); each shard must launch kernel
    C 7 a layer in the prefill, kernel A 7 and kernel B 1 a layer in every
    decode pass, and the flash forward 1 a layer in the prefill. This checks
    correctness and the kernels' shapes, not the speed of several cards.
    ``degrees`` (default TP_DEGREES) and ``devices`` (default the card
    repeated): the four-card check (``tools/multicard_check.py``) passes
    tp = 4 over four cards."""
    import copy

    from seed_story_torch.parallel.mesh import make_mesh

    agent = stack.agent
    n = agent.cfg.llm.num_hidden_layers
    gcfg = GenerateConfig(max_new_tokens=TP_NEW, num_img_gen_tokens=agent.cfg.num_img_out_tokens,
                          eos_token_id=-1, cache_capacity=FLAGSHIP_CAPACITY, return_cache=False)
    pipe = StoryGenerationPipeline(stack.tokenizer, None, stack.visual_encode, None,
                                   StoryPipelineConfig(num_img_in_tokens=agent.cfg.num_img_in_tokens))
    prompt = pipe.cfg.instruction_prompt.format_map(
        {"instruction": CAPTION + image_comprehension_string(agent.cfg.num_img_in_tokens)})
    ids, ids_cmp = pipe._ids_and_masks(prompt, 1)
    feats = stack.visual_encode(PIXELS)
    outs, walls, tops, failures = {}, {}, {}, []
    tp_launches = defaultdict(int)

    def run(tp: int, gen):
        gen.automaton = tops[tp] = TopKRecorder(gen.automaton)
        for kernel in (flash_fwd, int8_linear_kernel, int8_gemm_kernel, decode_attn):
            kernel.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs[tp] = gen.generate(ids, feats, np.ones((1,), bool), ids_cmp)
        torch.cuda.synchronize()
        walls[tp] = time.perf_counter() - t1

    run(1, StoryGenerator(agent, gcfg))
    for tp in degrees or TP_DEGREES:
        t0 = time.perf_counter()
        tp_agent = copy.deepcopy(agent)
        tp_gen = StoryGenerator(tp_agent, gcfg, mesh=make_mesh(1, tp, devices=(
            devices or ["cuda:0"] * tp)))
        torch.cuda.synchronize()
        print(f"tp_decode tp={tp} build: {time.perf_counter() - t0:.3f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated [{label}]", flush=True)
        shard_counts = [defaultdict(int) for _ in range(tp)]
        handles = []
        for layer in tp_agent.llm.model.layers:
            for r in range(tp):
                for module in (layer.self_attn.shards[r], layer.mlp.shards[r]):
                    start = {}

                    def before(mod, args, kwargs, start=start):
                        start["n"] = {k: c() for k, c in LAUNCHES.items()}

                    def after(mod, args, kwargs, out, start=start, r=r, counts=shard_counts):
                        rows = args[0].shape[0] * args[0].shape[1]
                        phase = "prefill" if rows > 32 else "decode"
                        for k, c in LAUNCHES.items():
                            counts[r][phase, k] += c() - start["n"][k]

                    handles += [module.register_forward_pre_hook(before, with_kwargs=True),
                                module.register_forward_hook(after, with_kwargs=True)]
        run(tp, tp_gen)
        for k, c in LAUNCHES.items():
            tp_launches[k] += c()
        for handle in handles:
            handle.remove()
        a, b = outs[1]["generate_ids"], outs[tp]["generate_ids"]
        parted = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]), None)
        if parted is not None:
            top1 = dict(zip(tops[1].calls[parted][1].indices[0].tolist(),
                            tops[1].calls[parted][1].values[0].tolist()))
            top2 = dict(zip(tops[tp].calls[parted][1].indices[0].tolist(),
                            tops[tp].calls[parted][1].values[0].tolist()))
            ok = (int(b[parted]) in top1 and int(a[parted]) in top2
                  and max(top1.values()) - top1[int(b[parted])]
                  <= TIE_QUANTA * bf16_quantum(max(top1.values()))
                  and max(top2.values()) - top2[int(a[parted])]
                  <= TIE_QUANTA * bf16_quantum(max(top2.values())))
            if not ok:
                failures.append(f"tp={tp} parts from tp=1 at token {parted} beyond the tie rule")
        passes = len(b) - 1
        want = {("prefill", "int8_gemm"): 7 * n, ("prefill", "flash_fwd"): n,
                ("decode", "int8_linear"): 7 * n * passes, ("decode", "decode_attn"): n * passes}
        for r in range(tp):
            got = {k: shard_counts[r][k] for k in want}
            print(f"tp_decode tp={tp} shard {r}: launches "
                  f"{json.dumps({' '.join(k): v for k, v in got.items()})} over 1 prefill and "
                  f"{passes} decode passes [{label}]", flush=True)
            if got != want:
                failures.append(f"tp={tp} shard {r}: launches {got}, expected {want}")
        where = "on " + ", ".join(devices) if devices else "the shards on one card, in turn"
        print(f"tp_decode: tp={tp} {len(b)} tokens, {1e3 * walls[tp] / len(b):.2f} ms/token ({where}) "
              f"against tp=1 {1e3 * walls[1] / len(a):.2f} ms/token; "
              f"tokens {'equal' if parted is None else f'part at {parted} (near tie)'} "
              f"[{label}]", flush=True)
        del tp_gen, tp_agent
        free_memory()
    if failures:
        raise AssertionError(f"tp_decode phase failed: {failures}")
    return tp_launches


# ranks: the layouts of the vocabulary over model and of the int8 base over
# data, (name, preset, (data, model), quantize_base), LAYOUT_STEPS steps each
RANK_LAYOUTS = (("vocab", "fsdp_tp", (1, 2), False), ("int8", "fsdp", (2, 1), True))
LAYOUT_STEPS, LAYOUT_LR = 2, 1e-3


@contextlib.contextmanager
def whole_weight_layout():
    """The layout before the vocabulary split and the int8 base's data
    shards, for s/step and peak memory beside theirs: ``split_vocab_`` and
    ``shard_int8_base_`` made no-ops, so both stay whole on every rank."""
    from unittest import mock

    from seed_story_torch.parallel import sharding

    with mock.patch.object(sharding, "split_vocab_", lambda *args: False), \
            mock.patch.object(sharding, "shard_int8_base_", lambda *args: None):
        yield


def rank_worker(rank: int, world: int, port: int, out: str, label: str):
    """One of two ranks sharing the card over gloo (NCCL refuses two ranks on
    one device), CUDA tensors staged through the host: rank 0 first takes
    the world-of-1 reference step on the global batch; then both take a
    ``dp`` step on their halves, and the contrastive loss with negatives
    gathered across the ranks. Then, for each of RANK_LAYOUTS, rank 0 takes
    LAYOUT_STEPS world-of-1 steps on the global batch and both ranks the
    same steps in the layout and in the whole-weight layout; rank 0 holds
    the layout to its world-of-1 steps (``compare_sharded``)."""
    import torch.distributed as dist

    from seed_story_torch.models.discrete import contrastive_loss
    from seed_story_torch.parallel import collectives
    from seed_story_torch.parallel.mesh import make_mesh

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    collectives.initialize_multihost(device="cuda", backend="gloo")
    torch.cuda.set_device(0)
    cfg = parallel_agent_cfg(RANK_LAYERS)
    batch = train_batch(cfg)
    rng = np.random.RandomState(5)
    batch["image_embeds"] = rng.randn(batch["images"].shape[0], cfg.num_vit_tokens,
                                      cfg.vit_dim).astype(np.float32)
    del batch["images"]
    dev = torch.device("cuda", 0)
    train_cfg = TrainConfig(learning_rate=1e-3, warmup_steps=0, training_steps=10,
                            sharding_preset="dp")
    result = {}

    def one_step(trainer, b):
        before = kernel_launch_counts()
        trainer.model.train()
        metrics = trainer.accumulate_grads(b, derive_seed(0, 0))
        grads = torch.cat([p.grad.float().flatten() for p in trainer.params.values()])
        metrics.update(trainer.apply_updates())
        launches = [a - c for a, c in zip(kernel_launch_counts(), before)]
        return float(metrics["loss"]), float(metrics["grad_norm"]), grads, launches

    if rank == 0:
        agent = fill_module(ContinuousLVLM, cfg, dev, seed=1)
        trainer = Trainer(agent, make_stage2_loss_fn(agent), train_cfg,
                          trainable_mask=stage2_mask(agent))
        result["world1"] = one_step(trainer, to_device(batch, dev))
        del trainer, agent
        free_memory()
    dist.barrier()
    agent = fill_module(ContinuousLVLM, cfg, dev, seed=1)
    trainer = Trainer(agent, make_stage2_loss_fn(agent), train_cfg,
                      trainable_mask=stage2_mask(agent), mesh=make_mesh(2, 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, norm, grads, launches = one_step(trainer, to_device(local_rows(batch, rank, 2), dev))
    torch.cuda.synchronize()
    result["dp"] = (collectives.mean_metrics({"loss": loss})["loss"], norm, launches,
                    time.perf_counter() - t0)
    if rank == 0:
        ref = result.pop("world1")
        result["world1"] = ref[:2] + (ref[3],)
        result["grad_cos"] = float(torch.nn.functional.cosine_similarity(grads, ref[2], dim=0))
        result["grad_rel"] = float((grads - ref[2]).norm() / ref[2].norm())
    del trainer, agent, grads
    free_memory()
    result.update(layout_runs(rank, cfg, batch, dev, label))
    feats = torch.from_numpy(np.random.RandomState(6).randn(2, 8, 4096).astype(np.float32)).to(dev)
    img, txt = feats[0], feats[1]
    local = contrastive_loss(img[4 * rank:4 * rank + 4], txt[4 * rank:4 * rank + 4],
                             torch.tensor(10.0, device=dev), axis_name="data")
    result["contrastive"] = (collectives.mean_metrics({"l": float(local)})["l"],
                             float(contrastive_loss(img, txt, torch.tensor(10.0, device=dev))))
    result["forbidden"] = forbidden_imports()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def layout_runs(rank: int, cfg: AgentConfig, batch: dict, dev, label: str) -> dict:
    """RANK_LAYOUTS on this rank (``rank_worker``; a process group of two
    ranks): rank 0's world-of-1 steps of ``cfg``'s agent on the global
    ``batch`` (host arrays, ViT features given), then both ranks' steps in
    the layout and in the whole-weight layout on their rows; rank 0 holds
    the layout to its world-of-1 steps. Returns {layout: results}."""
    import torch.distributed as dist

    from seed_story_torch.parallel.mesh import make_mesh

    result = {}
    for name, preset, (data, model), quantize in RANK_LAYOUTS:
        def steps(mesh, rows, gather=True):
            agent = fill_module(ContinuousLVLM, cfg, dev, seed=1)
            if quantize:
                quantize_agent_(agent, base=True, kv=False)
            run = sharded_steps(agent, make_stage2_loss_fn(agent), stage2_mask(agent), rows,
                                mesh, preset if mesh is not None else None, LAYOUT_STEPS,
                                LAYOUT_LR, gather=gather)
            del agent
            free_memory()
            return run

        ref = steps(None, batch) if rank == 0 else None
        dist.barrier()
        rows = local_rows(batch, rank // model, data)
        run = steps(make_mesh(data, model), rows)
        with whole_weight_layout():  # timed only
            whole = steps(make_mesh(data, model), rows, gather=False)
        keep = ("seconds", "peak_gib", "vocab_bytes", "int8_bytes", "launches",
                "int8_gemm_launches")
        result[name] = {"run": {k: run[k] for k in keep}, "whole": {k: whole[k] for k in keep}}
        if rank == 0:
            scales = [k for k in ref["params"] if k.endswith("weight_scale")]
            int8 = scales + [k[:-len("_scale")] for k in scales]
            result[name].update(
                ref={k: ref[k] for k in keep},
                failures=compare_sharded(run, ref, f"parallel ranks {name} {preset} "
                                         f"({data}, {model})", label, LAYOUT_LR),
                int8_gather_equal=(sum(run["params"][k] == ref["params"][k] for k in int8),
                                   len(int8)))
        del ref, run, whole
        free_memory()
    return result


def phase_ranks(label: str):
    """Two processes on the one card over gloo: the ``dp`` step of two ranks
    against rank 0's world-of-1 step on the same global batch (the stage-2
    batch at LLaMA-2-7B width, RANK_LAYERS layers, the ViT features given):
    losses within 5e-3, grad norms within 1e-2, the averaged gradient's
    cosine to the global one >= 0.999; the contrastive loss across the
    ranks against the global batch's within 1e-5. Then RANK_LAYOUTS: (1, 2)
    ``fsdp_tp`` with the vocabulary split over ``model`` and (2, 1)
    ``fsdp`` with a ``quantize_base`` base's int8 weights over ``data``,
    each held to rank 0's world-of-1 steps (``compare_sharded``'s limits),
    a rank holding at most 55% of the vocabulary tables' or of the int8
    base's bytes, the int8 weights and scales gathered bit-equal to the
    whole ones and kernel C launched 3 x 7 a layer a step; s/step and peak
    GiB beside the whole-weight layout (``whole_weight_layout``)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(rank_worker, args=(2, port, out, label), nprocs=2, join=False,
                                 start_method="spawn")
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > 600:
                for proc in ctx.processes:
                    proc.terminate()
                raise AssertionError("parallel ranks: the two ranks did not finish in 600 s")
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    r0 = ranks[0]
    (loss1, norm1, launches1), (loss2, norm2, launches2, dp_s) = r0["world1"], r0["dp"]
    print(f"parallel ranks: 2 processes over gloo on one card, {time.perf_counter() - t0:.1f} s "
          f"in all; dp step {dp_s:.3f} s (gloo stages the gradients through the host); loss "
          f"{loss2:.6f} against world-of-1 {loss1:.6f}, grad_norm {norm2:.6f} against "
          f"{norm1:.6f}, gradient cosine {r0['grad_cos']:.6f}, relative difference "
          f"{r0['grad_rel']:.2e}; launches a rank fwd/dq/dkv {launches2[:3]} against "
          f"{launches1[:3]} [{label}]", flush=True)
    con = [r["contrastive"] for r in ranks]
    print(f"parallel ranks: contrastive loss across the ranks {con[0][0]:.7f} against the global "
          f"batch's {con[0][1]:.7f} [{label}]", flush=True)
    failures = [f for r in ranks for f in r["forbidden"]]
    if not abs(loss2 - loss1) <= 5e-3 * abs(loss1) or not abs(norm2 - norm1) <= 1e-2 * norm1:
        failures.append(f"dp step: loss {loss2} / grad_norm {norm2} against {loss1} / {norm1}")
    if not r0["grad_cos"] >= 0.999:
        failures.append(f"dp gradient cosine {r0['grad_cos']}")
    if not abs(con[0][0] - con[0][1]) <= 1e-5 * abs(con[0][1]) or con[0][0] != con[1][0]:
        failures.append(f"contrastive across ranks {con}")
    if launches2[1] != RANK_LAYERS + 2 or launches2[2] != RANK_LAYERS + 2:
        failures.append(f"dp step: launches {launches2}")
    layout_failures, launches = check_layouts(ranks, label)
    failures += layout_failures
    launches = [a + b for a, b in zip(launches2, launches)]
    if failures:
        raise AssertionError(f"parallel ranks phase failed: {failures}")
    return launches


def check_layouts(ranks: list, label: str, layers: int = RANK_LAYERS):
    """Prints and checks ``layout_runs``' results of two ranks at ``layers``
    layers; returns (failures, rank 0's launches of the layouts: fwd, dq,
    dkv, int8_gemm)."""
    r0, failures, launches = ranks[0], [], [0, 0, 0, 0]
    for name, preset, mesh, _ in RANK_LAYOUTS:
        failures += r0[name]["failures"]
        equal, n_int8 = r0[name]["int8_gather_equal"]
        for r in range(2):
            run, whole = ranks[r][name]["run"], ranks[r][name]["whole"]
            held = {k: run[f"{k}_bytes"] for k in ("vocab", "int8")}
            print(f"parallel ranks {name} {preset} {mesh} rank {r}: "
                  + ", ".join(f"{k} {h / 2**30:.4f} GiB of {w / 2**30:.4f} ({h / max(w, 1):.4f}; "
                              f"whole-weight layout {whole[f'{k}_bytes'][0] / 2**30:.4f})"
                              for k, (h, w) in held.items() if w)
                  + f"; s/step {run['seconds']} against {whole['seconds']} in the whole-weight "
                  f"layout; peak {max(run['peak_gib']):.2f} against {max(whole['peak_gib']):.2f} "
                  f"GiB; int8 gather bit-equal {equal} of {n_int8}; int8_gemm launches "
                  f"{run['int8_gemm_launches']} [{label}]", flush=True)
            kind = "int8" if name == "int8" else "vocab"
            if not held[kind][0] <= 0.55 * held[kind][1]:
                failures.append(f"{name} rank {r}: holds {held[kind]} of the {kind} bytes")
            want_gemm = 3 * 7 * layers * LAYOUT_STEPS if name == "int8" else 0
            if run["int8_gemm_launches"] != want_gemm:
                failures.append(f"{name} rank {r}: {run['int8_gemm_launches']} int8_gemm "
                                f"launches, expected {want_gemm}")
        if equal != n_int8 or (name == "int8" and n_int8 != 2 * 7 * layers):
            failures.append(f"{name}: int8 gather bit-equal {equal} of {n_int8}")
        run = r0[name]["run"]
        launches = [a + b for a, b in zip(launches, [*run["launches"], run["int8_gemm_launches"]])]
    return failures, launches


# stage3_ranks: the UNet's depth cut (SDXL's transformer_layers_per_block is
# (1, 2, 10)); one step each at (data 1, model 2) fsdp_tp and (2, 1) dp
STAGE3_RANK_DEPTH = (1, 1, 2)
STAGE3_RANK_LR = 1e-4


def digest(t: torch.Tensor) -> int:
    """An integer of the tensor's bits (their bytes weighted by position),
    to hold a frozen parameter bit-equal without a host copy."""
    b = t.detach().contiguous().view(-1).view(torch.uint8).to(torch.int64)
    return int((b * (torch.arange(b.numel(), device=b.device) % 1_000_003 + 1)).sum())


def held_bytes(model) -> dict:
    """The bytes of this rank's pieces of the UNet's parameters (a model
    with a ``unet``), of the LLaMA's ``embed_tokens`` and ``lm_head`` and
    of its int8 base (the int8 weights and their scales)."""
    from seed_story_torch.parallel.sharding import to_local

    out = {"unet": 0, "vocab": 0, "int8": 0}
    unet = {id(p) for p in getattr(model, "unet", torch.nn.Module()).parameters()}
    for name, p in model.named_parameters():
        n = to_local(p).numel() * p.element_size()
        out["unet"] += n if id(p) in unet else 0
        out["vocab"] += n if name.endswith(("embed_tokens.weight", "lm_head.weight")) else 0
        out["int8"] += n if p.dtype == torch.int8 or name.endswith("weight_scale") else 0
    return out


def gathered_grads(trainer) -> torch.Tensor:
    """The global gradient of every trained parameter in the trainer's
    order, flattened in f32 on the host: FSDP shards and tensor-parallel
    slices joined. A collective under a mesh: every rank calls it."""
    from seed_story_torch.parallel import sharding

    parts = []
    for name, p in trainer.params.items():
        g = torch.zeros_like(sharding.to_local(p)) if p.grad is None else sharding.to_local(p.grad)
        parts.append(trainer.whole_tensor(g, name, p).float().flatten().cpu())
    return torch.cat(parts)


def gathered_params(trainer) -> dict:
    """Every whole parameter of the trainer's model: a trained one on the
    host, a frozen one as its ``digest``. A collective under a mesh."""
    from seed_story_torch.parallel import sharding

    out = {}
    for name, t in trainer.model.state_dict().items():
        whole = trainer.whole_tensor(sharding.to_local(t), name, t)
        out[name] = whole.cpu() if name in trainer.params else digest(whole)
    return out


def sharded_steps(model, loss_fn, mask: dict, batch: dict, mesh, preset, steps: int, lr: float,
                  accum: int = 1, save_to=None, gather: bool = True) -> dict:
    """``steps`` steps of ``model`` (filled on this rank's card) over ``mesh``
    under ``preset`` (None: one process) on this rank's rows ``batch`` (host
    arrays; leaves stacked (accum, ...) when ``accum`` > 1). Returns each
    step's loss (the mean over the ranks), grad_norm, seconds and peak GiB,
    the first step's global gradient, the flash launches of the steps, the
    (batch, heads, queries, keys) its UNet attentions ran at and their
    number, kernel C's launches, this rank's bytes against the whole of the
    UNet's parameters (a model with a ``unet``), of the LLaMA's vocabulary
    tables and of its int8 base (``held_bytes``), the trained parameter
    names and ``gathered_params`` after the steps (without ``gather``: no
    gradient and no parameters); ``save_to``: a checkpoint directory the
    state is saved to after the steps."""
    from seed_story_torch.parallel import collectives
    from seed_story_torch.train.checkpoint import CheckpointManager

    whole = held_bytes(model)
    trainer = Trainer(model, loss_fn, TrainConfig(learning_rate=lr, warmup_steps=0,
                                                  training_steps=10, grad_accum_steps=accum,
                                                  sharding_preset=preset or "fsdp"),
                      trainable_mask=mask, mesh=mesh)
    held = held_bytes(model)
    shapes = set()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: shapes.add((args[0].shape[0], mod.to_q.weight.shape[0] // mod.dim_head,
                                      args[0].shape[1], args[-1].shape[1])))
        for m in model.modules() if isinstance(m, CrossAttention)]
    dev = next(model.parameters()).device
    on_card = dev.type == "cuda"
    local = to_device(batch, dev)
    out = {"loss": [], "grad_norm": [], "seconds": [], "peak_gib": [], "n_attn": len(hooks),
           **{f"{k}_bytes": (held[k], whole[k]) for k in held}}
    before = kernel_launch_counts()
    for step in range(steps):
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = trainer.accumulate_grads(local, derive_seed(0, step))
        if step == 0 and gather:
            out["grads"] = gathered_grads(trainer)
        m.update(trainer.apply_updates())
        if on_card:
            torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["peak_gib"].append(torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0)
        host = {k: float(v) for k, v in m.items()}
        if mesh is not None:  # rank 0's reference may run while the other ranks wait
            host = collectives.mean_metrics(host)
        out["loss"].append(host["loss"])
        out["grad_norm"].append(host["grad_norm"])
    counts = [a - b for a, b in zip(kernel_launch_counts(), before)]
    out["launches"], out["int8_gemm_launches"] = counts[:3], counts[3]
    for hook in hooks:
        hook.remove()
    out["shapes"], out["trained"] = sorted(shapes), list(trainer.params)
    if gather:
        out["params"] = gathered_params(trainer)
    if save_to is not None:
        ckpt = CheckpointManager(save_to)
        ckpt.save(steps, trainer)
        ckpt.wait()
    del trainer, local
    free_memory()
    return out


def stage3_steps(adapter_cfg, frozen, batch: dict, mesh, preset, steps: int, accum: int = 1,
                 draw=None, save_to=None, device=None) -> dict:
    """``sharded_steps`` of stage 3: an SDXLAdapter filled from seed 3 on
    ``device`` (default this rank's card), trained at STAGE3_RANK_LR on its resampler and UNet
    ``to_k`` / ``to_v`` through the stage-3 loss over ``frozen`` = (ViT or
    None, agent, VAE), the step's draws from ``draw`` (default: the loss's
    seeded draw at the global shape)."""
    vit, agent, vae = frozen
    adapter = fill_module(SDXLAdapter, adapter_cfg, device or torch.device(
        "cuda", torch.cuda.current_device()), seed=3)
    loss_fn = make_stage3_loss_fn(adapter, agent, vae, vit, draw=draw)
    out = sharded_steps(adapter, loss_fn, adapter_trainable_mask(adapter), batch, mesh, preset,
                        steps, STAGE3_RANK_LR, accum=accum, save_to=save_to)
    del adapter, loss_fn
    free_memory()
    return out


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """The cosine of two long vectors, summed in f64 (f32 sums over 1e8
    entries part by percents)."""
    a, b = a.double(), b.double()
    return float(a @ b / (a.norm() * b.norm()))


def share_text(run: dict) -> str:
    """A rank's bytes of the UNet, the vocabulary tables and the int8 base
    against the whole (``sharded_steps``' results), for those the model has."""
    parts = [f"{kind} bytes a rank {held / 2**30:.3f} GiB of {whole / 2**30:.3f} "
             f"({held / whole:.4f})" for kind in ("unet", "vocab", "int8")
             for held, whole in [run[f"{kind}_bytes"]] if whole]
    return "; ".join(parts) or "no UNet, vocabulary or int8 bytes"


def compare_sharded(run: dict, ref: dict, what: str, label: str, lr: float) -> list:
    """A sharded run against the one-process run on the global batch
    (``sharded_steps``' results): losses within 5e-3 and grad norms within
    1e-2 (relative), the first step's gradient cosine >= 0.999, the trained
    parameters within 2.5 x lr a step of the reference's (an Adam step moves
    an entry by about lr, so the two runs part by 2 lr a step where a
    gradient entry near 0 takes the other sign; the rest is slack for the
    decay term and rounding) and every frozen parameter bit-equal (the
    gathered shards in their places). Prints the comparison; returns the
    failures."""
    failures = []
    cos = cosine(run["grads"], ref["grads"])
    trained = set(run["trained"])
    diff = max(float((run["params"][k] - ref["params"][k]).abs().max()) for k in trained)
    frozen_differ = [k for k in ref["params"] if k not in trained
                     and run["params"][k] != ref["params"][k]]
    print(f"{what}: losses {run['loss']} against {ref['loss']}, grad_norm {run['grad_norm']} "
          f"against {ref['grad_norm']}, gradient cosine {cos:.6f}, trained parameters max |diff| "
          f"{diff:.3g} (lr {lr}), {len(frozen_differ)} of {len(ref['params']) - len(trained)} "
          f"frozen differ; s/step {run['seconds']} against {ref['seconds']}, peak "
          f"{max(run['peak_gib']):.2f} against {max(ref['peak_gib']):.2f} GiB; {share_text(run)}; "
          f"flash launches fwd/dq/dkv {run['launches']}, int8_gemm {run['int8_gemm_launches']}; "
          f"UNet attention (batch, heads, queries, keys) {run['shapes']} [{label}]", flush=True)
    for i, (a, b) in enumerate(zip(run["loss"], ref["loss"])):
        if not abs(a - b) <= 5e-3 * abs(b):
            failures.append(f"{what} step {i + 1}: loss {a} against {b}")
    for i, (a, b) in enumerate(zip(run["grad_norm"], ref["grad_norm"])):
        if not abs(a - b) <= 1e-2 * b:
            failures.append(f"{what} step {i + 1}: grad_norm {a} against {b}")
    if not cos >= 0.999:
        failures.append(f"{what}: gradient cosine {cos}")
    if not diff <= 2.5 * lr * len(ref["loss"]):
        failures.append(f"{what}: trained parameters differ by {diff}")
    if frozen_differ:
        failures.append(f"{what}: frozen {frozen_differ[:3]} differ")
    return failures


def stage3_rank_worker(rank: int, world: int, port: int, out: str):
    """One of two ranks sharing the card over gloo: rank 0 first takes the
    world-of-1 stage-3 step on the global batch; then both take one step at
    (data 1, model 2) ``fsdp_tp`` and at (2, 1) ``dp`` on their rows."""
    import torch.distributed as dist

    from seed_story_torch.parallel import collectives
    from seed_story_torch.parallel.mesh import make_mesh

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    collectives.initialize_multihost(device="cuda", backend="gloo")
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    agent_cfg = parallel_agent_cfg(RANK_LAYERS)
    frozen = (None, fill_module(ContinuousLVLM, agent_cfg, dev, seed=1).eval().requires_grad_(False),
              fill_module(AutoencoderKL, VAEConfig(), dev, seed=2).eval().requires_grad_(False))
    batch = stage3_batch(agent_cfg)
    batch["image_embeds"] = np.random.RandomState(5).randn(
        batch["images"].shape[0], agent_cfg.num_vit_tokens, agent_cfg.vit_dim).astype(np.float32)
    del batch["images"]
    adapter_cfg = SDXLAdapterConfig(unet=SDXLUNetConfig(
        transformer_layers_per_block=STAGE3_RANK_DEPTH))
    result = {}
    if rank == 0:
        result["world1"] = stage3_steps(adapter_cfg, frozen, batch, None, None, steps=1)
    dist.barrier()
    for preset, (data, model) in (("fsdp_tp", (1, 2)), ("dp", (2, 1))):
        run = stage3_steps(adapter_cfg, frozen, local_rows(batch, rank // model, data),
                           make_mesh(data, model), preset, steps=1)
        result[preset] = run if rank == 0 else {"launches": run["launches"]}
    result["forbidden"] = forbidden_imports()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def phase_stage3_ranks(label: str):
    """Two processes on the card over gloo (NCCL refuses two ranks on one
    device): stage 3 at SDXL width with the UNet's depth cut to
    STAGE3_RANK_DEPTH, the agent to RANK_LAYERS layers (the ViT features
    given), two 1024x1024 targets; one step at (data 1, model 2) ``fsdp_tp``
    (the UNet's Megatron split: its attentions at 5 and 10 of 10 and 20
    heads) and one at (2, 1) ``dp``, each against rank 0's world-of-1 step
    on the same global batch (``compare_sharded``), every UNet attention
    launching the flash forward, dq and dk/dv once on each rank, and a rank
    of the split holding at most 60% of the UNet's parameter bytes."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        ctx = mp.start_processes(stage3_rank_worker, args=(2, port, out), nprocs=2, join=False,
                                 start_method="spawn")
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > 400:
                for proc in ctx.processes:
                    proc.terminate()
                raise AssertionError("stage3_ranks: the two ranks did not finish in 400 s")
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    print(f"stage3_ranks: 2 processes over gloo on one card, {time.perf_counter() - t0:.1f} s "
          f"in all; UNet transformer_layers_per_block {STAGE3_RANK_DEPTH}, LLaMA-2-7B width with "
          f"{RANK_LAYERS} layers [{label}]", flush=True)
    ref = ranks[0]["world1"]
    n_unet_attn = ref["n_attn"]
    failures = [f for r in ranks for f in r["forbidden"]]
    towers_fwd = RANK_LAYERS + 2  # the LLaMA's layers and both resamplers
    launches = [0, 0, 0]
    for preset in ("fsdp_tp", "dp"):
        failures += compare_sharded(ranks[0][preset], ref, f"stage3_ranks {preset}", label,
                                    STAGE3_RANK_LR)
        for r in range(2):
            fwd, dq, dkv = ranks[r][preset]["launches"]
            if dq != n_unet_attn or dkv != n_unet_attn or fwd != n_unet_attn + towers_fwd:
                failures.append(f"{preset} rank {r}: launches fwd/dq/dkv {fwd}/{dq}/{dkv}, "
                                f"expected {n_unet_attn + towers_fwd}/{n_unet_attn}")
        launches = [a + b for a, b in zip(launches, ranks[0][preset]["launches"])]
    rank_bytes, whole_bytes = ranks[0]["fsdp_tp"]["unet_bytes"]
    if not rank_bytes <= 0.6 * whole_bytes:
        failures.append(f"fsdp_tp: a rank holds {rank_bytes / whole_bytes:.3f} of the UNet")
    if failures:
        raise AssertionError(f"stage3_ranks phase failed: {failures}")
    return launches


def phase_framework_free(label: str):
    """The framework-free copies: which image path the native loader takes
    here (``native_available``: g++ and libjpeg), against the Python
    transform on the same jpg."""
    from PIL import Image

    from seed_story_torch.data import native_loader
    from seed_story_torch.data.transforms import ImageTransform

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "frame.jpg")
        Image.fromarray(np.random.RandomState(3).randint(0, 255, (300, 400, 3), np.uint8)).save(
            path, quality=95)
        native = native_loader.native_available()
        out = native_loader.NativeImageTransform("clip", keep_ratio=True, image_size=448)(path)
        ref = ImageTransform(type="clip", keep_ratio=True, image_size=448)(Image.open(path))
    diff = float(np.abs(out - ref).mean())
    print(f"framework_free: native_available() {native}, image path "
          f"{'native (libjpeg)' if native else 'PIL'}; mean |native - PIL| {diff:.4f} [{label}]",
          flush=True)
    if out.shape != (3, 448, 448) or not (diff < 0.12 if native else diff == 0.0):
        raise AssertionError(f"framework_free: shape {out.shape}, mean difference {diff}")


def released_agent_state_dict(agent, added_tokens: dict) -> dict:
    """``agent``'s state dict as zero_to_fp32 leaves a stage-2 agent (the
    reference's PEFT-wrapped llm), f32 on the host: ``llm.base_model.model.``
    names, ``base_layer`` / ``lora_A.default`` for the LoRA projections, each
    layernorm as a ``modules_to_save.default`` copy beside an
    ``original_module`` one (ones: the frozen original), and the true vocab's
    rows in the released order that ``added_tokens`` ({token: released id})
    gives. The resamplers keep their names and sin-cos tables."""
    vocab = agent.cfg.llm.vocab_size
    released_ids = torch.arange(vocab)
    for i, tok in enumerate(special_tokens()):
        released_ids[LLAMA_VOCAB_SIZE + i] = added_tokens[tok]
    lora = {name for name, m in agent.llm.named_modules()
            if isinstance(m, LoRADense) and m.lora_rank > 0}
    out = {}
    for key, value in agent.state_dict().items():
        value = value.detach().to("cpu", torch.float32)
        if not key.startswith("llm."):
            out[key] = value
            continue
        owner, _, leaf = key[len("llm."):].rpartition(".")
        name = f"llm.base_model.model.{owner}"
        if owner in ("model.embed_tokens", "lm_head"):
            rows = torch.empty((vocab,) + tuple(value.shape[1:]))
            rows[released_ids] = value[:vocab]
            out[f"{name}.{leaf}"] = rows
        elif owner in lora:
            out[f"{name}.base_layer.{leaf}"] = value
        elif owner.rpartition(".")[2] in ("lora_A", "lora_B"):
            out[f"{name}.default.{leaf}"] = value
        elif owner.rpartition(".")[2] in PEFT_NORMS:
            out[f"{name}.original_module.{leaf}"] = torch.ones_like(value)
            out[f"{name}.modules_to_save.default.{leaf}"] = value
        else:
            out[f"{name}.{leaf}"] = value
    return out


def phase_converted(label: str):
    """A released-layout agent bin at 7B width (CONVERTED_LAYERS layers)
    through ``tools/convert_torch_weights`` (``--int8`` and float), loaded as
    ``build_stack`` loads ``--agent_ckpt`` and decoded on the flagship
    configuration, against the same agent quantized in memory. Returns the
    converted agent's kernel launches in its decode (prefill included)."""
    bf16, n = torch.bfloat16, CONVERTED_LAYERS
    cfg = AgentConfig(llm=LlamaConfig(lora_rank=16, lora_alpha=32.0, lora_dropout=0.05,
                                      param_dtype=bf16, num_hidden_layers=n))

    def agent_of(seed: int):
        return fill_module(ContinuousLVLM, cfg, "cuda", seed=seed).eval().requires_grad_(False)

    ref = agent_of(11)
    gen = torch.Generator(device="cuda").manual_seed(12)
    with torch.no_grad():  # trained norms and LoRA B (the initialisation has ones and zeros)
        for w in (ref.llm.model.embed_tokens.weight, ref.llm.lm_head.weight):
            w[cfg.llm.vocab_size:] = 0  # the padding rows, zero in a converted file
        for m in ref.llm.modules():
            if isinstance(m, RMSNorm):
                m.weight.normal_(1.0, 0.1, generator=gen)
            elif isinstance(m, LoRADense) and m.lora_rank > 0:
                m.lora_B.weight.normal_(0.0, 0.02, generator=gen)
    order = np.random.RandomState(13).permutation(len(special_tokens()))
    added = {tok: LLAMA_VOCAB_SIZE + int(order[i]) for i, tok in enumerate(special_tokens())}
    n_in = cfg.num_img_in_tokens
    tok = TinyTokenizer()
    ids = np.asarray([tok.bos_token_id] + tok.encode(CAPTION + image_comprehension_string(n_in),
                                                     add_special_tokens=False))
    ids_cmp = np.zeros(len(ids), bool)
    ids_cmp[-n_in - 1:-1] = True
    failures, secs = [], {}

    with tempfile.TemporaryDirectory() as tmp:
        paths = {name: os.path.join(tmp, name) for name in (
            "pytorch_model.bin", "added_tokens.json", "agent_int8.pt", "agent.pt")}
        t0 = time.perf_counter()
        torch.save(released_agent_state_dict(ref, added), paths["pytorch_model.bin"])
        with open(paths["added_tokens.json"], "w") as f:
            json.dump(added, f)
        secs["write_bin"] = time.perf_counter() - t0
        argv = ["--family", "agent", "--input", paths["pytorch_model.bin"], "--num_layers",
                str(n), "--added_tokens_json", paths["added_tokens.json"]]
        reports = {}
        for name, extra in (("agent_int8.pt", ["--int8"]), ("agent.pt", [])):
            t0 = time.perf_counter()
            reports[name] = convert_weights(argv + ["--output", paths[name]] + extra)
            secs[name] = time.perf_counter() - t0
        gib = {name: os.path.getsize(path) / 2**30 for name, path in paths.items()}
        counts = {name: (len(m), len(u)) for name, (m, u) in reports.items()}
        if any(c != (0, 0) for c in counts.values()):
            failures.append(f"converter missing / unexpected keys: {reports}")

        # the float file against the in-memory bf16 agent
        loaded = agent_of(14)
        load_checkpoint_(loaded, paths["agent.pt"])
        want_sd, got_sd = ref.state_dict(), loaded.state_dict()
        differ = [k for k, v in want_sd.items() if not torch.equal(got_sd[k], v)]
        with torch.no_grad():
            x = torch.as_tensor(ids[None], device="cuda")
            logits_diff = float((loaded.llm(x)["logits"].float()
                                 - ref.llm(x)["logits"].float()).abs().max())
        if differ or logits_diff != 0.0:
            failures.append(f"float file: {len(differ)} entries differ ({differ[:4]}), prefill "
                            f"logits max |diff| {logits_diff}")
        del loaded, want_sd, got_sd
        free_memory()

        # the int8 file as build_stack loads --agent_ckpt, against quantizing in memory
        quantize_agent_(ref, base=True, kv=True)
        agent = agent_of(15)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_checkpoint_(agent, paths["agent_int8.pt"],
                         lambda a: quantize_agent_(a, base=True, kv=True))
        torch.cuda.synchronize()
        secs["load_int8"] = time.perf_counter() - t0
    want_sd, got_sd = ref.state_dict(), agent.state_dict()
    differ = [k for k, v in want_sd.items() if got_sd[k].dtype != v.dtype
              or not torch.equal(got_sd[k], v)]
    n_int8 = sum(v.dtype == torch.int8 for v in got_sd.values())
    n_scales = sum(k.endswith("weight_scale") for k in got_sd)
    if differ or n_int8 != 7 * n or n_scales != 7 * n:
        failures.append(f"int8 file: {len(differ)} entries differ from in-memory quantization "
                        f"({differ[:4]}); {n_int8} int8 weights, {n_scales} scales")
    del want_sd, got_sd

    gcfg = GenerateConfig(max_new_tokens=CONVERTED_NEW, num_img_gen_tokens=cfg.num_img_out_tokens,
                          eos_token_id=-1, cache_capacity=FLAGSHIP_CAPACITY,
                          speculate_k=FLAGSHIP_K)
    feats = torch.randn((1, cfg.num_vit_tokens, cfg.vit_dim), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(16)).to(bf16)
    want = StoryGenerator(ref, gcfg).generate(ids, feats, np.ones((1,), bool),
                                              ids_cmp)["generate_ids"]
    clock = StageClock()
    clock.watch(agent.llm, lambda a, k: "prefill" if k["inputs_embeds"].shape[1] > FLAGSHIP_K + 1
                else "decode_pass")
    for kernel in (flash_fwd, int8_linear_kernel, int8_gemm_kernel, decode_attn):
        kernel.launches = 0
    got = StoryGenerator(agent, gcfg).generate(ids, feats, np.ones((1,), bool),
                                               ids_cmp)["generate_ids"]
    launches = {k: count() for k, count in LAUNCHES.items()}
    clock.close()
    equal = [int(t) for t in got] == [int(t) for t in want]
    passes = len(clock.calls["decode_pass"])
    per_pass = {k: clock.launches("decode_pass", k) for k in ("int8_linear", "decode_attn")}
    if not equal:
        failures.append(f"tokens of the converted agent ({len(got)}) against the in-memory "
                        f"agent's ({len(want)}): equal {equal}")
    if (clock.launches("prefill", "int8_gemm") != 7 * n or clock.launches("prefill") < n
            or per_pass != {"int8_linear": 7 * n * passes, "decode_attn": n * passes}):
        failures.append(f"launches: prefill int8_gemm {clock.launches('prefill', 'int8_gemm')}, "
                        f"flash_fwd {clock.launches('prefill')}; decode {per_pass} over "
                        f"{passes} passes")
    print(f"converted: {n} of 32 layers at 7B width; released bin {gib['pytorch_model.bin']:.2f} "
          f"GiB written in {secs['write_bin']:.2f} s; convert --int8 {secs['agent_int8.pt']:.2f} "
          f"s -> {gib['agent_int8.pt']:.2f} GiB, float {secs['agent.pt']:.2f} s -> "
          f"{gib['agent.pt']:.2f} GiB; missing / unexpected keys {counts['agent_int8.pt']} and "
          f"{counts['agent.pt']}; load --int8 {secs['load_int8']:.2f} s, {n_int8} int8 weights "
          f"and {n_scales} scales bit-equal to in-memory quantization; float file prefill "
          f"logits max |diff| {logits_diff}; decode {len(got)} tokens in {passes} passes, "
          f"{1e3 * clock.total_s('decode_pass') / max(len(got) - 1, 1):.2f} ms/token, prefill "
          f"{1e3 * clock.total_s('prefill'):.2f} ms; tokens equal {equal}; launches "
          f"{json.dumps(launches)} [{label}]", flush=True)
    del ref, agent
    free_memory()
    if failures:
        raise AssertionError(f"converted phase failed: {failures}")
    return launches


PROBE_REPORT = (
    ("probe_attn", "benchmarks/probe_attn_variants.py:77",
     ((2, 10, 4096, 64), dict(variant="base", block_q=128, block_kv=128))),
    ("probe_single_pass", "benchmarks/probe_attn_overhead.py:48", ((2, 10, 2048, 64), {})),
    ("probe_single_pass_fused_bh", "benchmarks/probe_attn_overhead.py:76",
     ((2, 10, 2048, 64), {})),
    ("probe_copy_only", "benchmarks/probe_attn_overhead.py:32 and benchmarks/probe_attn_dma.py:32",
     ((2, 10, 4096, 64), {})),
    ("probe_attn_packed2", "benchmarks/probe_attn_dma.py:51", ((2, 20, 1024, 64), {})),
)


def probe_entry(name: str, replaces: str, rows: list, launches: int, at) -> dict:
    """A probe kernel's entry of the kernels line: its numbers at the row
    ``at`` names, its largest error over every shape, and every row's device
    ms, bench ms and bound."""
    shape, fields = at
    mine = [r for r in rows if r["kernel"] == name]
    row = next(r for r in mine if tuple(r["shape"]) == shape
               and all(r.get(k) == v for k, v in fields.items()))
    return {"name": name, "route": "cuda", "source": "seed_story_torch/csrc/probe_attn.cu",
            "replaces": replaces, "launches": launches, "launches_by_path": {"probes": launches},
            "max_abs_err": max(r.get("o_max_abs", 0.0) for r in mine),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "library": row["library"], "exp_floor_ms": row["exp_floor_ms"],
            "at": {"shape": list(shape), **fields},
            "rows": [{k: r.get(k) for k in ("shape", "variant", "block_q", "block_kv", "plan",
                                            "ms", "cold_ms", "bench_ms", "bound_ms",
                                            "library_ms")}
                     for r in mine]}


def compare_with_baseline(path: str, int8_rows: list, attn_rows: list, gemm_rows: list):
    """Prints each decode kernel's and kernel C's device ms beside the one an
    earlier run logged at the same shape and form (that run's own
    "int8_linear <name>: {...}", "decode_attn <name>: {...}" and
    "int8_gemm <name> <form>: {...}" lines, e.g. the parent commit's smoke in
    the same call), and kernel C's sums over a UNet CFG step and a prefill
    beside that run's "int8_gemm per ...: N launches, {...}" lines."""
    with open(path) as f:
        text = f.read()
    logged = {(m.group(1), m.group(2)): json.loads(m.group(3)) for m in re.finditer(
        r"^(int8_linear|decode_attn|int8_gemm) ([^:]+): (\{.*\}) \[", text, re.M)}
    sums = {m.group(1): json.loads(m.group(2)) for m in re.finditer(
        r"^int8_gemm per (.+): \d+ launches, (\{.*\}) \[", text, re.M)}
    for kernel, rows in (("int8_linear", int8_rows), ("decode_attn", attn_rows),
                         ("int8_gemm", gemm_rows)):
        for row in rows:
            name = f"{row['name']} {row['form']}" if kernel == "int8_gemm" else row["name"]
            old = logged.get((kernel, name))
            if old is None:
                print(f"baseline {kernel} {name}: not in {path}", flush=True)
                continue
            print(f"baseline {kernel} {name}: ms {row['ms']:.5f} against "
                  f"{old['ms']:.5f} ({row['ms'] / old['ms']:.3f}x), roofline "
                  f"{row['roofline']:.3f} against {old['roofline']:.3f}", flush=True)
    for what, (_, total) in int8_gemm_sums(gemm_rows).items():
        old = sums.get(what)
        if old is None:
            print(f"baseline int8_gemm per {what}: not in {path}", flush=True)
            continue
        print(f"baseline int8_gemm per {what}: ms {total['ms']:.3f} against {old['ms']:.3f} "
              f"({total['ms'] / old['ms']:.3f}x); bound {total['bound_ms']:.3f}, library "
              f"{total['library_ms']:.3f}", flush=True)


def tp_shapes(rows: list) -> dict:
    """A kernel's rows at the shapes of a --decode_tp 2 / 4 shard, for the
    kernels line."""
    return {r["name"]: {k: r[k] for k in ("shape", "ms", "bound_ms", "bound_by", "plain_ms",
                                          "library_ms")}
            for r in rows if r["name"].startswith(("tp2_", "tp4_"))}


def timed(name: str, phase, *args, **kwargs):
    """Runs one phase and prints its wall seconds."""
    t0 = time.perf_counter()
    out = phase(*args, **kwargs)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="log of an earlier run of this script (or of the "
                        "parent commit's) whose decode kernel and kernel C times to print "
                        "beside these")
    args = parser.parse_args()
    label = phase_device()
    rows = timed("kernels", phase_kernels, label)
    bwd_rows = timed("bwd_kernels", phase_bwd_kernels, label)
    int8_rows = timed("int8_kernel", phase_int8_kernel, label)
    gemm_rows = timed("int8_gemm_kernel", phase_int8_gemm_kernel, label)
    attn_rows = timed("decode_attn_kernel", phase_decode_attn_kernel, label)
    if args.baseline:
        compare_with_baseline(args.baseline, int8_rows, attn_rows, gemm_rows)
    probe_rows, probe_launches = timed("probes", phase_probes, label)
    story_launches, stack = timed("story", phase_story, label)
    flagship_launches, _ = timed("flagship", phase_flagship, label, stack)
    lockstep_launches, lockstep_stats, lockstep_segments = timed("lockstep", phase_lockstep,
                                                                 label, stack)
    serving_launches, _ = timed("serving", phase_serving, label, stack, lockstep_segments,
                                lockstep_stats["lockstep"]["wall_s"])
    tp_launches = timed("tp_decode", phase_tp_decode, label, stack)
    unet_int8_launches, _ = timed("unet_int8", phase_unet_int8, label, stack)  # last on the bf16 UNet
    del stack, lockstep_segments
    free_memory()  # the story stack is gone
    converted = timed("converted", phase_converted, label)
    (train_fwd, train_dq, train_dkv, _), train_stats = timed("train", phase_train, label)
    free_memory()
    (q_fwd, q_dq, q_dkv, q_gemm), q_stats = timed("train_int8", phase_train, label,
                                                  quantize_base=True)
    print(f"train_int8 against train (bf16): s/step {q_stats['s_per_step']:.3f} against "
          f"{train_stats['s_per_step']:.3f}, tokens/s {q_stats['tokens_per_s']:.1f} against "
          f"{train_stats['tokens_per_s']:.1f}, peak {q_stats['peak_gib']:.2f} against "
          f"{train_stats['peak_gib']:.2f} GiB, int8_gemm launches a step "
          f"{q_stats['int8_gemm_per_step']} [{label}]", flush=True)
    free_memory()
    stage3_fwd, stage3_dq, stage3_dkv = timed("stage3", phase_stage3, label)
    free_memory()
    stage1_fwd = timed("stage1", phase_stage1, label)
    free_memory()
    ipa_fwd = timed("ipa", phase_ipa, label)
    free_memory()
    sd21_fwd, sd21_dq, sd21_dkv = timed("sd21_edit", phase_sd21_edit, label)
    free_memory()
    (align_fwd, align_dq, align_dkv), align_story_fwd, align_attn = timed("align", phase_align,
                                                                          label)
    free_memory()
    nopool_fwd = timed("vit_nopool", phase_vit_nopool, label)
    free_memory()
    par_fwd, par_dq, par_dkv, par_gemm = timed("world_of_one", phase_world_of_one, label)
    rank_fwd, rank_dq, rank_dkv, rank_gemm = timed("ranks", phase_ranks, label)
    s3r_fwd, s3r_dq, s3r_dkv = timed("stage3_ranks", phase_stage3_ranks, label)
    timed("framework_free", phase_framework_free, label)
    at = next(r for r in rows if r["name"] == "unet_self_64x64")
    bat = next(r for r in bwd_rows if r["name"] == "llama_train_causal")
    a_at = next(r for r in int8_rows if r["name"] == "gate_up_m5")
    b_at = next(r for r in attn_rows if r["name"] == "int8_s5_c900")
    c_at = next(r for r in gemm_rows if r["name"] == "unet1280_geglu")
    flash_paths = {"story": story_launches["flash_fwd"],
                   "flagship": flagship_launches["flash_fwd"],
                   "lockstep": lockstep_launches["flash_fwd"],
                   "serving": serving_launches["flash_fwd"], "train": train_fwd,
                   "train_int8": q_fwd, "stage3": stage3_fwd, "stage1": stage1_fwd,
                   "ipa": ipa_fwd, "sd21_edit": sd21_fwd,
                   "align": align_fwd + align_story_fwd, "vit_nopool": nopool_fwd,
                   "tp_decode": tp_launches["flash_fwd"], "world_of_one": par_fwd,
                   "ranks": rank_fwd, "converted": converted["flash_fwd"],
                   "stage3_ranks": s3r_fwd}
    attn_paths = {"story": story_launches["decode_attn"],
                  "flagship": flagship_launches["decode_attn"],
                  "lockstep": lockstep_launches["decode_attn"],
                  "serving": serving_launches["decode_attn"], "align": align_attn,
                  "tp_decode": tp_launches["decode_attn"], "converted": converted["decode_attn"]}
    int8_paths = {"flagship": flagship_launches["int8_linear"],
                  "lockstep": lockstep_launches["int8_linear"],
                  "serving": serving_launches["int8_linear"],
                  "tp_decode": tp_launches["int8_linear"], "converted": converted["int8_linear"]}
    gemm_paths = {"flagship": flagship_launches["int8_gemm"],
                  "lockstep": lockstep_launches["int8_gemm"],
                  "serving": serving_launches["int8_gemm"], "unet_int8": unet_int8_launches,
                  "train_int8": q_gemm, "tp_decode": tp_launches["int8_gemm"],
                  "world_of_one": par_gemm, "converted": converted["int8_gemm"],
                  "ranks": rank_gemm}
    print(label, flush=True)
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": "seed_story_torch/csrc/flash_fwd.cu",
         "replaces": "seed_story_tpu/ops/attention.py:180",
         "launches": sum(flash_paths.values()), "launches_by_path": flash_paths,
         "max_abs_err": max(r["o_max_abs"] for r in rows + bwd_rows), "ms": at["ms"],
         "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
         "library_ms": at["library_ms"], "library": at["library"], "at": at["name"],
         "tp_shapes": tp_shapes(rows),
         # the IP adapters' and the SD-2.1 UNet's shapes
         "new_shapes": {r["name"]: {k: r[k] for k in (
             "shape", "ms", "bound_ms", "bound_by", "plain_ms", "library_ms", "o_max_abs")}
             for r in rows if r["name"] in NEW_SHAPE_NAMES}},
        *({"name": f"flash_bwd_{kname}", "route": "cuda",
           "source": "seed_story_torch/csrc/flash_bwd.cu",
           "replaces": f"seed_story_tpu/ops/attention.py:{line}",
           "launches": sum(by_path.values()), "launches_by_path": by_path,
           "max_abs_err": max(max(r[f"{g}_max_abs"] for g in grads) for r in bwd_rows),
           "ms": bat[f"{kname}_ms"], "plain_ms": bat["plain_ms"],
           "bound_ms": bat[f"{kname}_bound_ms"], "bound_by": bat[f"{kname}_bound_by"],
           "library_ms": bat["library_ms"], "library": f"{bat['library']}: dq, dk and dv",
           "at": bat["name"],
           # the stage-3 UNet shapes; plain_ms and library_ms there cover dq, dk and dv
           "unet_shapes": {r["name"]: {k: r[k] for k in (
               f"{kname}_ms", f"{kname}_bound_ms", f"{kname}_bound_by", "plain_ms",
               "library_ms", *(f"{g}_max_rel" for g in grads))}
               for r in bwd_rows if r["name"] in UNET_BWD_CASES}}
          for kname, line, by_path, grads in (
              ("dq", 398, {"train": train_dq, "train_int8": q_dq, "stage3": stage3_dq,
                           "sd21_edit": sd21_dq, "align": align_dq, "world_of_one": par_dq,
                           "ranks": rank_dq, "stage3_ranks": s3r_dq}, ("dq",)),
              ("dkv", 453, {"train": train_dkv, "train_int8": q_dkv, "stage3": stage3_dkv,
                            "sd21_edit": sd21_dkv, "align": align_dkv, "world_of_one": par_dkv,
                            "ranks": rank_dkv, "stage3_ranks": s3r_dkv}, ("dk", "dv")))),
        {"name": "int8_linear", "route": "cuda", "source": "seed_story_torch/csrc/int8_linear.cu",
         "replaces": "seed_story_tpu/models/llama.py:294 (XLA-fused, no Pallas kernel)",
         "launches": sum(int8_paths.values()), "launches_by_path": int8_paths,
         "max_abs_err": max(r["max_abs"] for r in int8_rows), "ms": a_at["ms"],
         "plain_ms": a_at["plain_ms"], "bound_ms": a_at["bound_ms"],
         "bound_by": a_at["bound_by"], "library_ms": a_at["library_ms"],
         "library": "F.linear on a pre-dequantized bf16 weight", "at": a_at["name"],
         "tp_shapes": tp_shapes(int8_rows)},
        {"name": "int8_gemm", "route": "cuda", "source": "seed_story_torch/csrc/int8_gemm.cu",
         "replaces": "seed_story_tpu/models/llama.py:294 and seed_story_tpu/models/sdxl/unet.py:68 "
                     "(XLA-fused, no Pallas kernel)",
         "launches": sum(gemm_paths.values()), "launches_by_path": gemm_paths,
         "max_abs_err": max(r["max_abs"] for r in gemm_rows), "ms": c_at["ms"],
         "plain_ms": c_at["plain_ms"], "bound_ms": c_at["bound_ms"],
         "bound_by": c_at["bound_by"], "library_ms": c_at["library_ms"],
         "library": c_at["library"], "at": c_at["name"], "tp_shapes": tp_shapes(gemm_rows),
         "rows": [{k: r[k] for k in ("name", "form", "shape", "plan", "ms", "bound_ms",
                                     "plain_ms", "library_ms", "max_rel")} for r in gemm_rows]},
        {"name": "decode_attn", "route": "cuda", "source": "seed_story_torch/csrc/decode_attn.cu",
         "replaces": "seed_story_tpu/ops/attention.py:105 (XLA, no Pallas kernel)",
         "launches": sum(attn_paths.values()), "launches_by_path": attn_paths,
         "max_abs_err": max(r["o_max_abs"] for r in attn_rows), "ms": b_at["ms"],
         "plain_ms": b_at["plain_ms"], "bound_ms": b_at["bound_ms"],
         "bound_by": b_at["bound_by"], "library_ms": b_at["library_ms"],
         "library": f"SDPA on a dequantized cache: {b_at['library']}", "at": b_at["name"],
         "tp_shapes": tp_shapes(attn_rows)},
        *(probe_entry(name, replaces, probe_rows, probe_launches[name], at)
          for name, replaces, at in PROBE_REPORT),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
