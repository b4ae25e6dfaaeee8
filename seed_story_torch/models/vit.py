"""Qwen-VL ViT-bigG visual tokenizer with attention pooling, and its no-pool
variant, in PyTorch; counterpart of ``seed_story_tpu/models/vit.py``.

448 px -> 14 px conv patchify (1024 tokens, width 1664) -> + bicubic pos-emb
-> ln_pre -> 48 pre-LN blocks (fused qkv split per head, exact GELU, eps
1e-6) [-> perceiver attn-pool to 256 queries -> ln_post -> projection].
Names follow the reference's ``qwen_visual`` state dict.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mha
from ..ops.dense import layer_norm, linear
from ..ops.sincos import interpolate_abs_pos
from .resampler import Resampler


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 448
    patch_size: int = 14
    width: int = 1664
    layers: int = 48
    heads: int = 16
    mlp_ratio: float = 4.9231
    n_queries: int = 256
    output_dim: int = 4096
    ln_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        base = dict(image_size=56, patch_size=14, width=64, layers=2, heads=4,
                    mlp_ratio=4.0, n_queries=16, output_dim=128)
        base.update(kw)
        return ViTConfig(**base)


class VisualAttention(nn.Module):
    """Fused-QKV self-attention. The reference views the projection as
    (l, b, heads, 3 * head_dim) and splits the last dim, so q, k and v are
    interleaved per head."""

    def __init__(self, width: int, heads: int, dtype, param_dtype):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.in_proj = nn.Linear(width, 3 * width, dtype=param_dtype)
        self.out_proj = nn.Linear(width, width, dtype=param_dtype)

    def forward(self, x):
        b, l, e = x.shape
        hd = e // self.heads
        qkv = linear(self.in_proj, x, self.dtype).view(b, l, self.heads, 3 * hd)
        q, k, v = (t.transpose(1, 2) for t in qkv.split(hd, dim=-1))
        out = mha(q, k, v, causal=False).transpose(1, 2).reshape(b, l, e)
        return linear(self.out_proj, out, self.dtype)


class VisualMLP(nn.Module):
    def __init__(self, width: int, mlp_width: int, dtype, param_dtype):
        super().__init__()
        self.dtype = dtype
        self.c_fc = nn.Linear(width, mlp_width, dtype=param_dtype)
        self.c_proj = nn.Linear(mlp_width, width, dtype=param_dtype)

    def forward(self, x):
        return linear(self.c_proj, F.gelu(linear(self.c_fc, x, self.dtype)), self.dtype)


class VisualBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.ln_1 = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.attn = VisualAttention(cfg.width, cfg.heads, cfg.dtype, cfg.param_dtype)
        self.ln_2 = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.mlp = VisualMLP(cfg.width, int(cfg.width * cfg.mlp_ratio), cfg.dtype,
                             cfg.param_dtype)

    def forward(self, x):
        x = x + self.attn(layer_norm(self.ln_1, x, self.dtype))
        return x + self.mlp(layer_norm(self.ln_2, x, self.dtype))


class Transformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(VisualBlock(cfg) for _ in range(cfg.layers))

    def forward(self, x):
        for block in self.resblocks:
            x = block(x)
        return x


class VisionTransformer(nn.Module):
    """The no-pool ViT: patchify, position table, ln_pre and the block
    stack, returning every token's features (N, grid * grid, width). Its
    names are those of :class:`VisionTransformerWithAttnPool`, so that
    model's weights load here with ``strict=False`` (the pool's tensors
    left out)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        pd = cfg.param_dtype
        self.conv1 = nn.Conv2d(3, cfg.width, cfg.patch_size, stride=cfg.patch_size,
                               bias=False, dtype=pd)
        self.positional_embedding = nn.Parameter(torch.empty(256, cfg.width, dtype=pd))
        self.ln_pre = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.transformer = Transformer(cfg)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: (N, 3, H, W) CLIP-normalized -> (N, grid * grid, width)."""
        cfg, dt = self.cfg, self.cfg.dtype
        x = F.conv2d(pixels.to(dt), self.conv1.weight.to(dt), stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)  # (N, grid*grid, width), row-major tokens
        x = x + interpolate_abs_pos(self.positional_embedding.to(dt), x.shape[1])[None]
        x = layer_norm(self.ln_pre, x, dt)
        return self.transformer(x)


class VisionTransformerWithAttnPool(VisionTransformer):
    def __init__(self, cfg: ViTConfig):
        super().__init__(cfg)
        pd = cfg.param_dtype
        self.attn_pool = Resampler(
            grid_size=int(math.sqrt(cfg.n_queries)), embed_dim=cfg.output_dim,
            num_heads=max(1, cfg.output_dim // 128), kv_dim=cfg.width, ln_eps=cfg.ln_eps,
            dtype=cfg.dtype, param_dtype=pd)
        self.ln_post = nn.LayerNorm(cfg.output_dim, eps=cfg.ln_eps)
        self.proj = nn.Parameter(torch.empty(cfg.output_dim, cfg.output_dim, dtype=pd))

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: (N, 3, H, W) CLIP-normalized -> (N, n_queries, output_dim)."""
        dt = self.cfg.dtype
        x = layer_norm(self.ln_post, self.attn_pool(super().forward(pixels)), dt)
        return x @ self.proj.to(dt)
