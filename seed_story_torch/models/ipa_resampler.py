"""The de-tokenizer's perceiver heads in PyTorch: ``ResamplerXLV2`` (the
shipped one), ``ResamplerXL`` (V1: no input normalization),
``ResamplerXLIdentity`` and the IP-Adapter's ``IPAResampler``; counterpart
of ``seed_story_tpu/models/ipa_resampler.py``. Names follow the reference's
``models_ipa/resampler.py`` state dict (``layers.{i}.0`` the attention,
``layers.{i}.1`` the feed-forward ``Sequential``,
``unet_attnpool.{q,k,v,c}_proj``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dense import layer_norm, linear


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        self.dim_head, self.heads, self.dtype = dim_head, heads, dtype
        inner = dim_head * heads
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False, dtype=param_dtype)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False, dtype=param_dtype)
        self.to_out = nn.Linear(inner, dim, bias=False, dtype=param_dtype)

    def forward(self, x, latents):
        """x: (B, n1, D) features; latents: (B, n2, D). KV = [x; latents]."""
        dt = self.dtype
        x = layer_norm(self.norm1, x, dt)
        latents = layer_norm(self.norm2, latents, dt)
        b, l, _ = latents.shape
        q = linear(self.to_q, latents, dt)
        k, v = linear(self.to_kv, torch.cat([x, latents], dim=-2), dt).chunk(2, dim=-1)

        def heads_first(t):
            return t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)

        q, k, v = heads_first(q), heads_first(k), heads_first(v)
        scale = self.dim_head ** -0.25  # q and k are each scaled (reference :69-70)
        w = torch.softmax((q * scale).float() @ (k * scale).float().transpose(-1, -2), dim=-1)
        out = (w @ v.float()).to(dt).transpose(1, 2).reshape(b, l, -1)
        return linear(self.to_out, out, dt)


class FeedForward(nn.Sequential):
    """Sequential(LayerNorm, Linear, GELU, Linear) as in the reference."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32, param_dtype=torch.float32):
        inner = int(dim * mult)
        super().__init__(nn.LayerNorm(dim), nn.Linear(dim, inner, bias=False, dtype=param_dtype),
                         nn.GELU(), nn.Linear(inner, dim, bias=False, dtype=param_dtype))
        self.dtype = dtype

    def forward(self, x):
        norm, fc1, _, fc2 = self
        return linear(fc2, F.gelu(linear(fc1, layer_norm(norm, x, self.dtype), self.dtype)),
                      self.dtype)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling: mean token prepended, learned pos-emb,
    one attention query, output projection to ``output_dim``."""

    def __init__(self, seq_len: int, embed_dim: int, num_heads: int, output_dim=None,
                 dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.positional_embedding = nn.Parameter(
            torch.empty(seq_len + 1, embed_dim, dtype=param_dtype))
        self.q_proj = nn.Linear(embed_dim, embed_dim, dtype=param_dtype)
        self.k_proj = nn.Linear(embed_dim, embed_dim, dtype=param_dtype)
        self.v_proj = nn.Linear(embed_dim, embed_dim, dtype=param_dtype)
        self.c_proj = nn.Linear(embed_dim, output_dim or embed_dim, dtype=param_dtype)

    def forward(self, x):
        dt = self.dtype
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)[None]
        b, lk, e = x.shape
        h = self.num_heads
        hd = e // h

        def heads_first(t):
            return t.reshape(b, t.shape[1], h, hd).transpose(1, 2).float()

        q = heads_first(linear(self.q_proj, x[:, :1], dt))
        k = heads_first(linear(self.k_proj, x, dt))
        v = heads_first(linear(self.v_proj, x, dt))
        w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        out = (w @ v).to(dt).transpose(1, 2).reshape(b, 1, e)
        return linear(self.c_proj, out, dt)[:, 0]


def _perceiver_layers(dim, depth, dim_head, heads, ff_mult, dtype, param_dtype):
    return nn.ModuleList(
        nn.ModuleList([PerceiverAttention(dim, dim_head, heads, dtype, param_dtype),
                       FeedForward(dim, ff_mult, dtype, param_dtype)])
        for _ in range(depth))


class IPAResampler(nn.Module):
    """The IP-Adapter's perceiver: learned latents cross-attend to the
    projected features, then proj_out and an f32 LayerNorm."""

    def __init__(self, dim: int = 1024, depth: int = 8, dim_head: int = 64, heads: int = 16,
                 num_queries: int = 8, embedding_dim: int = 768, output_dim: int = 1024,
                 ff_mult: int = 4, dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.latents = nn.Parameter(torch.empty(1, num_queries, dim, dtype=param_dtype))
        self.proj_in = nn.Linear(embedding_dim, dim, dtype=param_dtype)
        self.layers = _perceiver_layers(dim, depth, dim_head, heads, ff_mult, dtype, param_dtype)
        self.proj_out = nn.Linear(dim, output_dim, dtype=param_dtype)
        self.norm_out = nn.LayerNorm(output_dim)

    def forward(self, x):
        """x: (B, n, embedding_dim) -> (B, num_queries, output_dim)."""
        dt = self.dtype
        latents = self.latents.to(dt).expand(x.shape[0], -1, -1)
        x = linear(self.proj_in, x, dt)
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        return layer_norm(self.norm_out, linear(self.proj_out, latents, dt), dt)


class ResamplerXLV2(nn.Module):
    """The shipped de-tokenizer head: dim 1024, depth 4, 64 queries, input
    4096, outputs 768 + 1280 prompt embeds and a 1280-d pooled embed."""

    l2_normalize_input = True  # the V2 difference

    def __init__(self, dim: int = 1024, depth: int = 4, dim_head: int = 64, heads: int = 16,
                 num_queries: int = 64, embedding_dim: int = 4096, output1_dim: int = 768,
                 output2_dim: int = 1280, ff_mult: int = 4, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.latents = nn.Parameter(torch.empty(1, num_queries, dim, dtype=param_dtype))
        self.proj_in = nn.Linear(embedding_dim, dim, dtype=param_dtype)
        self.layers = _perceiver_layers(dim, depth, dim_head, heads, ff_mult, dtype, param_dtype)
        self.norm_out = nn.LayerNorm(dim)
        self.unet_proj_1 = nn.Linear(dim, output1_dim, dtype=param_dtype)
        self.unet_proj_2 = nn.Linear(dim, output2_dim, dtype=param_dtype)
        self.unet_attnpool = AttentionPool2d(num_queries, dim, heads, output2_dim, dtype,
                                             param_dtype)

    def forward(self, x):
        """x: (B, n, embedding_dim) -> (prompt_embeds (B, nq, out1 + out2),
        pooled (B, out2))."""
        dt = self.dtype
        latents = self.latents.to(dt).expand(x.shape[0], -1, -1)
        if self.l2_normalize_input:
            # The reference calls F.normalize(x) with torch's default dim=1:
            # the features are normalized over the TOKEN axis. The released
            # checkpoints were trained through it, so it is kept as is.
            xf = x.float()
            x = xf / torch.sqrt((xf * xf).sum(dim=1, keepdim=True)).clamp(min=1e-12)
        x = linear(self.proj_in, x, dt)
        for attn, ff in self.layers:
            latents = attn(x, latents) + latents
            latents = ff(latents) + latents
        hidden = layer_norm(self.norm_out, latents, dt)
        prompt = torch.cat([linear(self.unet_proj_1, hidden, dt),
                            linear(self.unet_proj_2, hidden, dt)], dim=-1)
        return prompt, self.unet_attnpool(hidden)


class ResamplerXL(ResamplerXLV2):
    """V1: ResamplerXLV2 without the input L2 normalization."""

    l2_normalize_input = False


class ResamplerXLIdentity(nn.Module):
    """Passes the prompt embeds and the pooled embeds through."""

    def forward(self, x, pooled_text_embeds=None):
        return x, pooled_text_embeds
