"""What the attention probes share: the guard that they run on a card, the
card's label, seeded inputs and the chained-call timer."""

from __future__ import annotations

import subprocess
import time

import torch


def require_cuda(device) -> torch.device:
    """The device a probe runs on: a CUDA card unless the caller asks for
    the CPU (where every probe function takes its plain version)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the attention probes run on a CUDA card and none is present; "
                           "pass device='cpu' for the plain versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the attention probes run on 'cuda' or 'cpu', not {device}")
    return device


def card_label(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    "cpu (host clock)"."""
    if torch.device(device).type != "cuda":
        return "cpu (host clock)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def qkv(shape, device: torch.device):
    """Three seeded standard-normal bf16 tensors of ``shape``, made on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(0)
    return tuple(torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
                 for _ in range(3))


def bench(f, *args, n: int = 20) -> float:
    """Seconds a call of ``f``: ``n`` dependent calls ``x = f(x, *args[1:])``
    from ``x = args[0]``, best of 3 chains after one warm-up chain.
    On a card the chain runs between two CUDA events with no host sync
    inside it; on the CPU the host clock times it."""
    x0, rest = args[0], args[1:]

    def chain():
        x = x0
        for _ in range(n):
            x = f(x, *rest)
        return x

    chain()
    best = float("inf")
    if x0.is_cuda:
        torch.cuda.synchronize(x0.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            start.record()
            chain()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
    else:
        for _ in range(3):
            t0 = time.perf_counter()
            chain()
            best = min(best, time.perf_counter() - t0)
    return best / n
