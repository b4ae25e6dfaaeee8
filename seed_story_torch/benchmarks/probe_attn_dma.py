"""Memory-traffic probe for d = 64 attention: the copy-only kernel at d = 64,
a d = 128 control with the same bytes, and head-pair packing (two d = 64
heads side by side in 128-wide rows).

    python -m seed_story_torch.benchmarks.probe_attn_dma

The counterpart of ``benchmarks/probe_attn_dma.py``. Its "parallel-sem"
line has none here: ``dimension_semantics`` is a TPU megacore hint with no
counterpart in a CUDA grid. It runs on a CUDA card and raises without one
(``device="cpu"`` runs the plain versions, with host-clock times).
"""

from __future__ import annotations

from ..ops.attention import mha
from .common import bench, card_label, qkv, require_cuda
from .probe_kernels import attn_packed2, copy_only

SHAPE = (2, 20, 1024, 64)


def main(device="cuda", shape=SHAPE, n: int = 20) -> list:
    """Runs the probe; returns one dict a printed line."""
    device = require_cuda(device)
    print(f"probe_attn_dma [{card_label(device)}]", flush=True)
    b, h, s, d = shape
    q, k, v = qkv((b, h, s, d), device)
    tf = 4 * b * h * s * s * d / 1e12
    rows = []

    t = bench(copy_only, q, k, v, n=n)
    print(f"copy d={d}   : {t * 1e3:8.4f} ms ({t / (b * h) * 1e6:6.2f} us/prog)", flush=True)
    rows.append(dict(shape=[b, h, s, d], name="copy_only", ms=t * 1e3))

    q2, k2, v2 = qkv((b, h // 2, s, 2 * d), device)
    t = bench(copy_only, q2, k2, v2, n=n)
    print(f"copy d={2 * d} same bytes  : {t * 1e3:8.4f} ms ({t / (b * h // 2) * 1e6:6.2f} us/prog)",
          flush=True)
    rows.append(dict(shape=[b, h // 2, s, 2 * d], name="copy_only", ms=t * 1e3))
    del q2, k2, v2

    t = bench(attn_packed2, q, k, v, n=n)
    print(f"attn packed-2head d={2 * d}: {t * 1e3:8.4f} ms  {tf / t:6.1f} TF/s", flush=True)
    rows.append(dict(shape=[b, h, s, d], name="attn_packed2", ms=t * 1e3))

    ref = mha(q, k, v, causal=False, implementation="plain").float()
    err = float((attn_packed2(q, k, v).float() - ref).abs().max())
    print(f"packed-2head max|diff| = {err:.2e}", flush=True)
    rows.append(dict(shape=[b, h, s, d], name="attn_packed2_max_diff", max_abs=err))
    return rows


if __name__ == "__main__":
    main()
