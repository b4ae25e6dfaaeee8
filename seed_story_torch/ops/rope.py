"""Rotary position embeddings (LLaMA half-rotation form) with linear and
dynamic-NTK scaling; counterpart of ``seed_story_tpu/ops/rope.py``.
cos/sin are computed in f32 at the given positions."""

from __future__ import annotations

from typing import Optional

import torch


def rope_frequencies(head_dim: int, positions: torch.Tensor, *, base: float = 10000.0,
                     scaling_type: Optional[str] = None, scaling_factor: float = 1.0,
                     max_position_embeddings: int = 4096,
                     seq_len: Optional[float] = None):
    """cos/sin of shape positions.shape + (head_dim,), float32.
    scaling_type: None | 'linear' | 'dynamic' (NTK-aware)."""
    positions = positions.float()
    eff_base = torch.tensor(base, dtype=torch.float32, device=positions.device)
    if scaling_type == "linear":
        positions = positions / scaling_factor
    elif scaling_type == "dynamic":
        if seq_len is None:
            seq_len = positions.max() + 1.0
        seq_len = torch.clamp(torch.as_tensor(seq_len, dtype=torch.float32,
                                              device=positions.device),
                              min=float(max_position_embeddings))
        eff_base = base * ((scaling_factor * seq_len / max_position_embeddings)
                           - (scaling_factor - 1.0)) ** (head_dim / (head_dim - 2.0))
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=positions.device) / head_dim
    inv_freq = 1.0 / (eff_base ** exponents)
    angles = positions[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """q, k: (B, H, S, D); cos/sin: (B, S, D) or (S, D). Rotates in f32 and
    returns q.dtype."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, None], sin[:, None]
    dtype = q.dtype
    qf, kf = q.float(), k.float()
    q_out = qf * cos + rotate_half(qf) * sin
    k_out = kf * cos + rotate_half(kf) * sin
    return q_out.to(dtype), k_out.to(dtype)
