"""GroupNorm over channels-last (NHWC) activations with f32 statistics;
counterpart of ``seed_story_tpu/ops/groupnorm.py::FastGroupNorm``.

Statistics are the sum and sum of squares in f32 (variance E[x^2] - E[x]^2,
clamped at 0), folded into a per-(batch, channel) affine applied to the
input; the result is cast back to the input dtype. Parameters are named
``weight``/``bias`` as in ``torch.nn.GroupNorm`` (diffusers' names) and kept
in f32."""

from __future__ import annotations

import torch
from torch import nn


class FastGroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels not divisible by {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(num_channels, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, ..., C) channels last."""
        b, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        cg = c // g
        xg = x.reshape(b, -1, g, cg).float()
        n = xg.shape[1] * cg
        mean = xg.sum(dim=(1, 3)) / n
        var = torch.clamp(xg.square().sum(dim=(1, 3)) / n - mean * mean, min=0.0)
        inv = torch.rsqrt(var + self.eps)  # (B, G)
        a = inv[..., None] * self.weight.float().reshape(g, cg)  # (B, G, cg)
        shift = self.bias.float().reshape(g, cg) - mean[..., None] * a
        y = xg * a[:, None] + shift[:, None]
        return y.reshape(x.shape).to(x.dtype)
