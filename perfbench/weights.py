"""Seeded weights, made on the device in a few large draws and handed to both
the program and the reference.

The parameters are taken in the order of their names; one generator on the
device draws standard normals in chunks of ``CHUNK`` values, and each
parameter takes its slice of that stream, scaled by a rule of its name and
shape, rounded to bfloat16 (the type the configurations serve in), then
copied into the parameter's own dtype. So two parameter sets with the same
names and shapes get the same values whatever their dtypes, and the
reference, which holds f32 copies, holds exactly the program's bf16 values.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

CHUNK = 1 << 27  # normals a draw: 512 MiB in f32


def leaf_scale(name: str, shape) -> tuple:
    """(mean, std) of a parameter: unit-mean norm scales and small biases
    for 1-D leaves; for matrices and kernels 1 / sqrt(fan_in), fan_in being
    every axis but the first of a 4-D kernel and the last axis otherwise;
    LoRA's B a tenth of that, so that the adapter adds a small term as a
    trained one does."""
    if len(shape) <= 1:
        return (0.0, 0.02) if name.endswith("bias") else (1.0, 0.05)
    fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[-1]
    std = 1.0 / math.sqrt(fan_in)
    if "lora_B" in name.split("."):
        std *= 0.1
    return 0.0, std


@torch.no_grad()
def fill_(params: Dict[str, torch.Tensor], seed: int, device) -> None:
    """Fills every tensor of ``params`` (name -> tensor on ``device``) in
    place from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    names = sorted(params)
    buf, pos = None, CHUNK
    for name in names:
        p = params[name]
        mean, std = leaf_scale(name, tuple(p.shape))
        flat = p.view(-1)
        done = 0
        while done < flat.numel():
            if pos == CHUNK:
                buf = torch.randn(CHUNK, generator=gen, device=device, dtype=torch.float32)
                pos = 0
            take = min(CHUNK - pos, flat.numel() - done)
            vals = (buf[pos:pos + take] * std + mean).to(torch.bfloat16)
            flat[done:done + take].copy_(vals)
            done += take
            pos += take


def named_params(module: torch.nn.Module, prefixes=None) -> Dict[str, torch.Tensor]:
    """Name -> parameter of ``module``, only those under ``prefixes`` when
    given."""
    out = {}
    for name, p in module.named_parameters():
        if prefixes is None or name.startswith(tuple(prefixes)):
            out[name] = p
    return out


def spec(params: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    return {name: tuple(p.shape) for name, p in params.items()}
