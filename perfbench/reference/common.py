"""Plain float32 building blocks of the reference models.

Nothing here imports the program. Every product runs in float32 with TF32
off (``f32_math``); a layer's parameters are f32 tensors holding the values
the benchmark's seeded weights gave the program. ``fake_quantize_`` puts a
weight through a symmetric per-output-channel integer grid (the reference's
own derivation of an int8 weight, and the control's int4 / int8 weights).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def f32_math():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def fake_quantize_(w: torch.Tensor, levels: int) -> torch.Tensor:
    """In place: w -> s * clamp(round(w / s), -levels, levels) with s = max
    |w| / levels over every axis but the first, floored at 1e-8 (levels 127
    for int8, 7 for int4)."""
    wf = w.float()
    s = (wf.abs().flatten(1).amax(dim=1) / levels).clamp_min(1e-8)
    s = s.view(-1, *[1] * (w.dim() - 1))
    w.copy_(torch.round(wf / s).clamp(-levels, levels) * s)
    return w


E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor, dim=None) -> torch.Tensor:
    """t rounded to float8 e4m3 under a scale that maps its largest magnitude
    (over the whole tensor, or each slice along ``dim``) to the format's
    largest value; returned in float32."""
    amax = t.abs().amax() if dim is None else t.abs().flatten(1).amax(dim=1)
    s = (amax / E4M3_MAX).clamp_min(1e-30)
    if dim is not None:
        s = s.view(-1, *[1] * (t.dim() - 1))
    return (t / s).to(torch.float8_e4m3fn).float() * s


def compute_in_fp8_(module: nn.Module) -> nn.Module:
    """In place: every matrix product and convolution of ``module`` (its
    ``Lin`` and ``Conv`` layers) takes float8 e4m3 operands, the weight
    rounded once per output channel, the input per call."""
    for m in module.modules():
        if hasattr(m, "fp8"):
            m.fp8 = True
            m.weight.data.copy_(fp8_round(m.weight.data, dim=0))
    return module


class Lin(nn.Module):
    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.fp8 = False
        self.weight = nn.Parameter(torch.empty(n_out, n_in), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(n_out), requires_grad=False) if bias else None

    def forward(self, x):
        return F.linear(fp8_round(x) if self.fp8 else x, self.weight, self.bias)


class Norm(nn.Module):
    """LayerNorm (``bias``) or RMSNorm parameters."""

    def __init__(self, dim: int, eps: float, bias: bool = True):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim), requires_grad=False) if bias else None

    def forward(self, x):
        if self.bias is None:  # RMSNorm
            return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.weight
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


def sincos_2d(embed_dim: int, grid: int) -> np.ndarray:
    """(grid**2, embed_dim) 2-D sin-cos table: the first half encodes the
    row, the second the column (the Qwen resampler's)."""
    def one_d(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.arange(grid, dtype=np.float32)
    mesh = np.stack(np.meshgrid(g, g), axis=0).reshape(2, 1, grid, grid)
    return np.concatenate([one_d(embed_dim // 2, mesh[0]), one_d(embed_dim // 2, mesh[1])],
                          axis=1).astype(np.float32)


def resize_pos(table: torch.Tensor, n: int) -> torch.Tensor:
    """A square (L, C) position table resampled bicubically to n positions."""
    src, tgt = int(math.isqrt(table.shape[0])), int(math.isqrt(n))
    if src == tgt:
        return table
    grid = table.reshape(1, src, src, -1).permute(0, 3, 1, 2)
    out = F.interpolate(grid, size=(tgt, tgt), mode="bicubic", align_corners=False)
    return out.permute(0, 2, 3, 1).reshape(tgt * tgt, -1)


def attention(q, k, v, causal: bool = False, scale=None, rows: int = 4):
    """softmax(q k^T * scale) v over (B, H, S, d) tensors in blocks of
    ``rows`` (batch, head) pairs, so that the scores of one block fit."""
    b, h, sq, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q2, k2, v2 = (t.reshape(b * h, t.shape[2], d) for t in (q, k, v))
    out = torch.empty_like(q2)
    for i in range(0, b * h, rows):
        s = torch.matmul(q2[i:i + rows], k2[i:i + rows].transpose(1, 2)) * scale
        if causal:
            skv = s.shape[-1]
            pos = torch.arange(sq, device=s.device)[:, None] + (skv - sq)
            s = s.masked_fill(torch.arange(skv, device=s.device)[None] > pos, float("-inf"))
        out[i:i + rows] = torch.matmul(torch.softmax(s, dim=-1), v2[i:i + rows])
    return out.reshape(b, h, sq, d)


class QwenAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (fused in_proj, out_proj)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim), requires_grad=False)
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim), requires_grad=False)
        self.out_proj = Lin(dim, dim)

    def forward(self, q, k, v):
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        b, lq, e = q.shape
        hd = e // self.heads

        def split(t, w, bias):
            return F.linear(t, w, bias).view(b, t.shape[1], self.heads, hd).transpose(1, 2)

        out = attention(split(q, wq, bq), split(k, wk, bk), split(v, wv, bv))
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, e))


class QwenResampler(nn.Module):
    """The Qwen 2-D sin-cos resampler: learned queries cross-attend once to
    the (projected, normalized) inputs."""

    def __init__(self, grid: int, dim: int, heads: int, kv_dim: int, eps: float = 1e-5):
        super().__init__()
        self.register_buffer("pos_embed", torch.from_numpy(sincos_2d(dim, grid)),
                             persistent=False)
        self.query = nn.Parameter(torch.empty(grid * grid, dim), requires_grad=False)
        self.kv_proj = Lin(kv_dim, dim, bias=False) if kv_dim != dim else None
        self.ln_q = Norm(dim, eps)
        self.ln_kv = Norm(dim, eps)
        self.attn = QwenAttention(dim, heads)

    def forward(self, x):
        if self.kv_proj is not None:
            x = self.kv_proj(x)
        x = self.ln_kv(x)
        q = (self.ln_q(self.query) + self.pos_embed)[None].expand(x.shape[0], -1, -1)
        return self.attn(q, x + resize_pos(self.pos_embed, x.shape[1])[None], x)
