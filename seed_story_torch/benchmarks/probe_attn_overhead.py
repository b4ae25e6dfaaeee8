"""Per-program cost probe: the copy-only kernel, the single-pass softmax
kernel with one program per head, and the same with two heads a program,
over a shape sweep.

    python -m seed_story_torch.benchmarks.probe_attn_overhead

The counterpart of ``benchmarks/probe_attn_overhead.py``; the single pass
runs for S <= 2048 only, as there. It runs on a CUDA card and raises
without one (``device="cpu"`` runs the plain versions, with host-clock
times).
"""

from __future__ import annotations

import torch

from ..ops.attention import mha
from .common import bench, card_label, qkv, require_cuda
from .probe_kernels import copy_only, single_pass, single_pass_fused_bh

SHAPES = ((2, 20, 1024, 64), (2, 10, 2048, 64), (2, 10, 4096, 64))
SINGLE_PASS_MAX_SEQ = 2048


def main(device="cuda", shapes=SHAPES, n: int = 20) -> list:
    """Runs the probe; returns one dict a printed line."""
    device = require_cuda(device)
    print(f"probe_attn_overhead [{card_label(device)}]", flush=True)
    rows = []
    for (b, h, s, d) in shapes:
        q, k, v = qkv((b, h, s, d), device)
        tf = 4 * b * h * s * s * d / 1e12
        progs = b * h
        t = bench(copy_only, q, k, v, n=n)
        print(f"{(b, h, s, d)} copy-only   : {t * 1e3:8.4f} ms ({t / progs * 1e6:6.2f} us/prog)",
              flush=True)
        rows.append(dict(shape=[b, h, s, d], name="copy_only", ms=t * 1e3))
        if s <= SINGLE_PASS_MAX_SEQ:
            t = bench(single_pass, q, k, v, n=n)
            print(f"{(b, h, s, d)} single-pass : {t * 1e3:8.4f} ms  {tf / t:6.1f} TF/s "
                  f"({t / progs * 1e6:6.2f} us/prog)", flush=True)
            rows.append(dict(shape=[b, h, s, d], name="single_pass", ms=t * 1e3))
            t = bench(single_pass_fused_bh, q, k, v, n=n)
            print(f"{(b, h, s, d)} fused-2head : {t * 1e3:8.4f} ms  {tf / t:6.1f} TF/s",
                  flush=True)
            rows.append(dict(shape=[b, h, s, d], name="single_pass_fused_bh", ms=t * 1e3))
            ref = mha(q, k, v, causal=False, implementation="plain").float()
            err = float((single_pass(q, k, v).float() - ref).abs().max())
            print(f"{(b, h, s, d)} single-pass max|diff| = {err:.2e}", flush=True)
            rows.append(dict(shape=[b, h, s, d], name="single_pass_max_diff", max_abs=err))
            del ref
        del q, k, v
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
