"""Qwen-style 2-D sin-cos perceiver resampler (one cross-attention);
counterpart of ``seed_story_tpu/models/resampler.py``. Names follow the
reference's ``qwen_visual.Resampler`` (``query``, ``kv_proj``, ``ln_q``,
``ln_kv``, ``attn.in_proj_weight``, ``attn.out_proj``, ``pos_embed``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mha
from ..ops.dense import layer_norm
from ..ops.sincos import get_2d_sincos_pos_embed, interpolate_abs_pos


class MultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention``'s parameters (fused in_proj, out_proj),
    batch-first, attention through ``mha``."""

    def __init__(self, embed_dim: int, num_heads: int, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        self.embed_dim, self.num_heads, self.dtype = embed_dim, num_heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, dtype=param_dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim, dtype=param_dtype))
        self.out_proj = nn.Linear(embed_dim, embed_dim, dtype=param_dtype)

    def forward(self, q, k, v):
        e, h, dt = self.embed_dim, self.num_heads, self.dtype
        hd = e // h
        b, lq, _ = q.shape
        lk = k.shape[1]
        wq, wk, wv = self.in_proj_weight.to(dt).chunk(3, dim=0)
        bq, bk, bv = self.in_proj_bias.to(dt).chunk(3, dim=0)
        qh = F.linear(q, wq, bq).view(b, lq, h, hd).transpose(1, 2)
        kh = F.linear(k, wk, bk).view(b, lk, h, hd).transpose(1, 2)
        vh = F.linear(v, wv, bv).view(b, lk, h, hd).transpose(1, 2)
        out = mha(qh, kh, vh, causal=False)
        out = out.transpose(1, 2).reshape(b, lq, e)
        return F.linear(out, self.out_proj.weight.to(dt), self.out_proj.bias.to(dt))


class Resampler(nn.Module):
    def __init__(self, grid_size: int, embed_dim: int, num_heads: int,
                 kv_dim: Optional[int] = None, ln_eps: float = 1e-5,
                 dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        self.grid_size, self.embed_dim, self.dtype = grid_size, embed_dim, dtype
        self.num_queries = grid_size ** 2
        # frozen 2-D sin-cos table: a buffer, as in the reference
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim, grid_size)))
        self.query = nn.Parameter(torch.empty(self.num_queries, embed_dim, dtype=param_dtype))
        self.kv_proj = (nn.Linear(kv_dim, embed_dim, bias=False, dtype=param_dtype)
                        if kv_dim is not None and kv_dim != embed_dim else None)
        self.ln_q = nn.LayerNorm(embed_dim, eps=ln_eps)
        self.ln_kv = nn.LayerNorm(embed_dim, eps=ln_eps)
        self.attn = MultiheadAttention(embed_dim, num_heads, dtype, param_dtype)

    def forward(self, x):
        """x: (N, L, kv_dim) -> (N, num_queries, embed_dim)."""
        dt = self.dtype
        n, l, _ = x.shape
        pos_embed = self.pos_embed.to(dt)
        if self.kv_proj is not None:
            x = F.linear(x.to(dt), self.kv_proj.weight.to(dt))
        x = layer_norm(self.ln_kv, x, dt)
        q = layer_norm(self.ln_q, self.query.to(dt), dt)
        pos_k = interpolate_abs_pos(pos_embed, l)
        q_in = (q + pos_embed)[None].expand(n, -1, -1)
        return self.attn(q_in, x + pos_k[None], x)
