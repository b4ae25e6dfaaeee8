"""Kernel-variant probe for d = 64 full-mask attention at the SDXL UNet's
self-attention shapes: how much of the time the exponentials take.

    python -m seed_story_torch.benchmarks.probe_attn_variants

Prints, for each shape, the port's production attention (``mha``, the flash
kernel), each variant of :func:`~.probe_kernels.attn` (``base``: natural
exp; ``exp2``: the scale folded with log2 e; ``noexp``: no softmax) at each
tile instance, then the max |diff| of ``base`` and ``exp2`` against the
plain ``mha``. The counterpart of ``benchmarks/probe_attn_variants.py``;
it runs on a CUDA card and raises without one (``device="cpu"`` runs the
plain versions, with host-clock times).
"""

from __future__ import annotations

import torch

from ..ops.attention import mha
from .common import bench, card_label, qkv, require_cuda
from .probe_kernels import TILES, VARIANTS, attn

SHAPES = ((2, 10, 4096, 64), (2, 20, 1024, 64))


def main(device="cuda", shapes=SHAPES, n: int = 20) -> list:
    """Runs the probe; returns one dict a printed line."""
    device = require_cuda(device)
    clock = card_label(device)
    rows = []
    for (b, h, s, d) in shapes:
        q, k, v = qkv((b, h, s, d), device)
        tf = 4 * b * h * s * s * d / 1e12
        print(f"--- shape {(b, h, s, d)}  ({tf * 1e3:.0f} GF/call) [{clock}]", flush=True)
        t = bench(lambda q, k, v: mha(q, k, v, causal=False), q, k, v, n=n)
        print(f"prod mha (flash kernel)    : {t * 1e3:8.4f} ms  {tf / t:6.1f} TF/s", flush=True)
        rows.append(dict(shape=[b, h, s, d], name="mha", ms=t * 1e3))
        for variant in VARIANTS:
            for bq, bkv in TILES:
                if bq > s or bkv > s:
                    continue
                tt = bench(lambda q, k, v, vv=variant, a=bq, c=bkv: attn(q, k, v, vv, a, c),
                           q, k, v, n=n)
                print(f"{variant:6s} bq={bq:4d} bkv={bkv:4d}  : {tt * 1e3:8.4f} ms  "
                      f"{tf / tt:6.1f} TF/s", flush=True)
                rows.append(dict(shape=[b, h, s, d], name=variant, block_q=bq, block_kv=bkv,
                                 ms=tt * 1e3))
        # numeric sanity for the real candidates
        ref = mha(q, k, v, causal=False, implementation="plain").float()
        for variant in ("base", "exp2"):
            err = float((attn(q, k, v, variant).float() - ref).abs().max())
            print(f"{variant}: max|diff| vs plain mha = {err:.3e}", flush=True)
            rows.append(dict(shape=[b, h, s, d], name=f"{variant}_max_diff", max_abs=err))
        del ref, q, k, v
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
