"""2-D sin-cos positional embeddings and bicubic pos-emb resampling;
counterpart of ``seed_story_tpu/ops/sincos.py``."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = False) -> np.ndarray:
    """(grid_size**2, embed_dim) float32; first half encodes H, second W."""
    assert embed_dim % 2 == 0
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0).reshape([2, 1, grid_size, grid_size])
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    pos = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos = np.concatenate([np.zeros([1, embed_dim]), pos], axis=0)
    return pos.astype(np.float32)


def interpolate_abs_pos(abs_pos: torch.Tensor, tgt_len: int) -> torch.Tensor:
    """Bicubic-resample a (L, C) square-grid pos-emb to tgt_len positions
    (torch ``F.interpolate(mode='bicubic', align_corners=False)``, in f32)."""
    src = int(math.sqrt(abs_pos.shape[0]))
    tgt = int(math.sqrt(tgt_len))
    if tgt * tgt != tgt_len:
        raise ValueError(f"pos-emb interpolation needs a square token count, got {tgt_len}")
    if src == tgt:
        return abs_pos
    c = abs_pos.shape[-1]
    grid = abs_pos.float().reshape(1, src, src, c).permute(0, 3, 1, 2)
    out = F.interpolate(grid, size=(tgt, tgt), mode="bicubic", align_corners=False)
    return out.permute(0, 2, 3, 1).reshape(tgt * tgt, c).to(abs_pos.dtype)
