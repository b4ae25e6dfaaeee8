"""SDXL-base UNet2DConditionModel (float path) in PyTorch; counterpart of
``seed_story_tpu/models/sdxl/unet.py``.

Activations travel as NHWC tensors, as in the JAX package; every
convolution sees them through a free permute as an NCHW tensor in
channels_last memory. Module names follow diffusers' state dict
(``down_blocks.{i}.resnets.{j}``, ``...attentions.{j}.transformer_blocks.{k}
.attn1.to_q``, ``ff.net.0.proj``), which ``convert_sdxl_unet`` reads.
Attention goes through ``ops.attention.mha``.

The int8 UNet (``SDXLUNetConfig.quantize``, or ``quantize_unet_`` on a
float one in place): the modules of ``QUANTIZED_MODULES`` (the transformer
projections and the resnet / sampler convolutions) hold int8 weights with a
per-output-channel f32 ``weight_scale``. A linear layer runs ``int8_linear``
(kernels A and C on the card, no bf16 copy of its weight), a convolution
convolves its weight converted to ``dtype`` and scales the output (the JAX
``QConv``); both then add the bias. The conditioning MLPs and ``conv_in`` /
``conv_out`` stay float, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import mha
from ...ops.dense import layer_norm, linear, sharded
from ...ops.groupnorm import FastGroupNorm
from ..llama import quantize_weight


@dataclasses.dataclass(frozen=True)
class SDXLUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    down_block_types: Tuple[str, ...] = ("DownBlock2D", "CrossAttnDownBlock2D",
                                         "CrossAttnDownBlock2D")
    up_block_types: Tuple[str, ...] = ("CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D")
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    attention_head_dim: int = 64
    cross_attention_dim: int = 2048
    addition_embed_type: Optional[str] = "text_time"  # or None (no added conditioning)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816  # 6*256 + 1280
    pooled_projection_dim: int = 1280
    norm_num_groups: int = 32
    # weight-only int8 storage of QUANTIZED_MODULES (inference only: the UNet
    # is frozen in every training stage); a float UNet converts in place with
    # quantize_unet_
    quantize: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @staticmethod
    def tiny(**kw) -> "SDXLUNetConfig":
        base = dict(block_out_channels=(32, 64, 64), transformer_layers_per_block=(1, 1, 2),
                    attention_head_dim=16, cross_attention_dim=64, addition_time_embed_dim=32,
                    projection_class_embeddings_input_dim=32 * 6 + 64,
                    pooled_projection_dim=64, norm_num_groups=16, dtype=torch.float32)
        base.update(kw)
        return SDXLUNetConfig(**base)


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = True, downscale_freq_shift: float = 0.0,
                           max_period: int = 10000) -> torch.Tensor:
    """diffusers get_timestep_embedding, float32."""
    half = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[..., None] * torch.exp(exponent)[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


# The JAX module names whose weights an int8 UNet stores as int8
# (seed_story_tpu/models/sdxl/unet.py:131-141): the transformer projections
# and the resnet / sampler convolutions.
QUANTIZED_MODULES = frozenset({
    "to_q", "to_k", "to_v", "to_out_0", "net_0_proj", "net_2",
    "proj_in", "proj_out", "conv1", "conv2", "conv_shortcut", "conv",
})


def flax_module_name(path: str) -> str:
    """The JAX module name of the UNet submodule at ``path`` (diffusers
    names): ``attn1.to_out.0`` -> ``to_out_0``, ``ff.net.0.proj`` ->
    ``net_0_proj``, ``ff.net.2`` -> ``net_2``."""
    path = re.sub(r"\.(\d+)", r"_\1", path).replace("net_0.proj", "net_0_proj")
    return path.rpartition(".")[2]


def quantized_modules(unet: nn.Module):
    """(path, module) of every Linear / Conv2d of ``unet`` that an int8 UNet
    stores as int8."""
    return [(path, m) for path, m in unet.named_modules()
            if isinstance(m, (nn.Linear, nn.Conv2d))
            and flax_module_name(path) in QUANTIZED_MODULES]


def _set_int8_(layer: nn.Module, weight: torch.Tensor, scale: torch.Tensor):
    layer.weight = nn.Parameter(weight, requires_grad=False)
    layer.weight_scale = nn.Parameter(scale, requires_grad=False)


@torch.no_grad()
def quantize_unet_(unet: nn.Module) -> nn.Module:
    """In place, the counterpart of the JAX ``quantize_unet_params``: the
    weight of every module of ``quantized_modules`` becomes int8 with a
    per-output-channel f32 ``weight_scale`` (symmetric, max |w| / 127 over
    every other axis, floored at 1e-8; ``quantize_weight``), one module at a
    time, its float weight freed. Other parameters stay as they are; an
    already int8 module is left alone. Sets ``cfg.quantize``."""
    if not isinstance(unet, UNet2DConditionModel):
        raise TypeError(f"quantize_unet_ takes the UNet (an adapter's .unet), got "
                        f"{type(unet).__name__}")
    for _, m in quantized_modules(unet):
        if m.weight.dtype != torch.int8:
            _set_int8_(m, *quantize_weight(m.weight))
    unet.cfg = dataclasses.replace(unet.cfg, quantize=True)
    return unet


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` in ``dtype`` on an NHWC tensor (channels_last underneath).
    An int8 ``conv`` convolves its weight converted to ``dtype``, then
    multiplies by its scale and adds the bias, each rounded to ``dtype``
    (the JAX ``QConv``). A tensor-parallel shard of ``conv`` joins its group
    (``ops/dense.py::sharded``)."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    x = x.permute(0, 3, 1, 2).to(dtype)
    if conv.weight.dtype == torch.int8:
        y = F.conv2d(x, conv.weight.to(dtype), None, conv.stride, conv.padding)
        y = y.permute(0, 2, 3, 1) * conv.weight_scale.to(dtype)
        return y if bias is None else y + bias
    return sharded(lambda xs, b: F.conv2d(xs, conv.weight.to(dtype), b, conv.stride,
                                          conv.padding).permute(0, 2, 3, 1), conv, x, bias)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour 2x upsampling."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest").permute(0, 2, 3, 1)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int, dtype, param_dtype):
        super().__init__()
        self.dtype = dtype
        self.linear_1 = nn.Linear(in_dim, dim, dtype=param_dtype)
        self.linear_2 = nn.Linear(dim, dim, dtype=param_dtype)

    def forward(self, x):
        return linear(self.linear_2, F.silu(linear(self.linear_1, x, self.dtype)), self.dtype)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, cfg: SDXLUNetConfig):
        super().__init__()
        self.dtype = cfg.dtype
        pd = cfg.param_dtype
        self.norm1 = FastGroupNorm(cfg.norm_num_groups, in_channels, 1e-5)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, dtype=pd)
        self.time_emb_proj = nn.Linear(cfg.time_embed_dim, out_channels, dtype=pd)
        self.norm2 = FastGroupNorm(cfg.norm_num_groups, out_channels, 1e-5)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, dtype=pd)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1, dtype=pd)
                              if in_channels != out_channels else None)

    def forward(self, x, temb):
        dt = self.dtype
        h = conv_nhwc(self.conv1, F.silu(self.norm1(x)), dt)
        h = h + linear(self.time_emb_proj, F.silu(temb), dt)[:, None, None, :]
        h = conv_nhwc(self.conv2, F.silu(self.norm2(h)), dt)
        if self.conv_shortcut is not None:
            x = conv_nhwc(self.conv_shortcut, x, dt)
        return x + h


class CrossAttention(nn.Module):
    """diffusers Attention: to_q/k/v without bias, to_out.0 with bias. Its
    heads follow the projections: a tensor-parallel shard attends over the
    heads its ``to_q`` / ``to_k`` / ``to_v`` rows hold."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, context_dim: int,
                 dtype, param_dtype):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        inner = heads * dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False, dtype=param_dtype)
        self.to_k = nn.Linear(context_dim, inner, bias=False, dtype=param_dtype)
        self.to_v = nn.Linear(context_dim, inner, bias=False, dtype=param_dtype)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, dtype=param_dtype)])

    def forward(self, x, context=None):
        context = x if context is None else context
        dt, hd = self.dtype, self.dim_head
        b, lq, _ = x.shape
        lk = context.shape[1]
        q = linear(self.to_q, x, dt).view(b, lq, -1, hd).transpose(1, 2)
        k = linear(self.to_k, context, dt).view(b, lk, -1, hd).transpose(1, 2)
        v = linear(self.to_v, context, dt).view(b, lk, -1, hd).transpose(1, 2)
        out = mha(q, k, v, causal=False).transpose(1, 2).reshape(b, lq, -1)
        return linear(self.to_out[0], out, dt)


class GEGLU(nn.Module):
    """``proj``'s output is ``[h | gate]``; a tensor-parallel shard holds the
    same rows of both halves (``split_dense(..., chunks=2)``)."""

    def __init__(self, dim: int, inner: int, dtype, param_dtype):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Linear(dim, inner * 2, dtype=param_dtype)

    def forward(self, x):
        h, gate = linear(self.proj, x, self.dtype).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf, as diffusers' GEGLU


class FeedForwardGEGLU(nn.Module):
    def __init__(self, dim: int, dtype, param_dtype, mult: int = 4):
        super().__init__()
        self.dtype = dtype
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, dtype, param_dtype), nn.Identity(),
                                  nn.Linear(dim * mult, dim, dtype=param_dtype)])

    def forward(self, x):
        return linear(self.net[2], self.net[0](x), self.dtype)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int, dtype,
                 param_dtype):
        super().__init__()
        self.dtype = dtype
        # flax LayerNorm's default epsilon, as the JAX package uses it
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = CrossAttention(dim, heads, dim_head, dim, dtype, param_dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, dtype, param_dtype)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForwardGEGLU(dim, dtype, param_dtype)

    def forward(self, x, context):
        dt = self.dtype
        x = x + self.attn1(layer_norm(self.norm1, x, dt))
        x = x + self.attn2(layer_norm(self.norm2, x, dt), context)
        return x + self.ff(layer_norm(self.norm3, x, dt))


class Transformer2DModel(nn.Module):
    def __init__(self, channels: int, n_layers: int, cfg: SDXLUNetConfig):
        super().__init__()
        self.dtype = cfg.dtype
        pd = cfg.param_dtype
        self.norm = FastGroupNorm(cfg.norm_num_groups, channels, 1e-6)
        self.proj_in = nn.Linear(channels, channels, dtype=pd)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, channels // cfg.attention_head_dim,
                                  cfg.attention_head_dim, cfg.cross_attention_dim,
                                  cfg.dtype, pd)
            for _ in range(n_layers))
        self.proj_out = nn.Linear(channels, channels, dtype=pd)

    def forward(self, x, context):
        b, h, w, c = x.shape
        y = linear(self.proj_in, self.norm(x).reshape(b, h * w, c), self.dtype)
        for block in self.transformer_blocks:
            y = block(y, context)
        return x + linear(self.proj_out, y, self.dtype).reshape(b, h, w, c)


class Downsample2D(nn.Module):
    def __init__(self, channels: int, cfg: SDXLUNetConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, dtype=cfg.param_dtype)

    def forward(self, x):
        # diffusers pads (0, 1, 0, 1) and convolves with stride 2, no padding
        return conv_nhwc(self.conv, F.pad(x, (0, 0, 0, 1, 0, 1)), self.dtype)


class Upsample2D(nn.Module):
    def __init__(self, channels: int, cfg: SDXLUNetConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, dtype=cfg.param_dtype)

    def forward(self, x):
        return conv_nhwc(self.conv, upsample_nearest_2x(x), self.dtype)


class UNetBlock(nn.Module):
    """One diffusers down/mid/up block: resnets, attentions, samplers."""

    def __init__(self, resnets, attentions, sampler=None, sampler_name: str = "downsamplers"):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if sampler is not None:
            self.add_module(sampler_name, nn.ModuleList([sampler]))


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: SDXLUNetConfig):
        super().__init__()
        self.cfg = cfg
        ch, pd, n = cfg.block_out_channels, cfg.param_dtype, len(cfg.block_out_channels)
        self.time_embedding = TimestepEmbedding(ch[0], cfg.time_embed_dim, cfg.dtype, pd)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, cfg.time_embed_dim, cfg.dtype, pd)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1, dtype=pd)

        skip = [ch[0]]  # channels of the skip connections, pushed as forward does
        c_in = ch[0]
        self.down_blocks = nn.ModuleList()
        for bi in range(n):
            depth = (cfg.transformer_layers_per_block[bi]
                     if "CrossAttn" in cfg.down_block_types[bi] else 0)
            resnets, attentions = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(c_in, ch[bi], cfg))
                c_in = ch[bi]
                if depth:
                    attentions.append(Transformer2DModel(ch[bi], depth, cfg))
                skip.append(c_in)
            sampler = Downsample2D(ch[bi], cfg) if bi < n - 1 else None
            if sampler is not None:
                skip.append(c_in)
            self.down_blocks.append(UNetBlock(resnets, attentions, sampler, "downsamplers"))

        self.mid_block = UNetBlock(
            [ResnetBlock2D(ch[-1], ch[-1], cfg), ResnetBlock2D(ch[-1], ch[-1], cfg)],
            [Transformer2DModel(ch[-1], cfg.transformer_layers_per_block[-1], cfg)])

        up_ch = list(reversed(ch))
        up_depths = list(reversed(cfg.transformer_layers_per_block))
        self.up_blocks = nn.ModuleList()
        for bi in range(n):
            depth = up_depths[bi] if "CrossAttn" in cfg.up_block_types[bi] else 0
            resnets, attentions = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(c_in + skip.pop(), up_ch[bi], cfg))
                c_in = up_ch[bi]
                if depth:
                    attentions.append(Transformer2DModel(up_ch[bi], depth, cfg))
            sampler = Upsample2D(up_ch[bi], cfg) if bi < n - 1 else None
            self.up_blocks.append(UNetBlock(resnets, attentions, sampler, "upsamplers"))

        self.conv_norm_out = FastGroupNorm(cfg.norm_num_groups, ch[0], 1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1, dtype=pd)
        if cfg.quantize:  # the JAX quantize=True layout: int8 zeros, unit scales
            for _, m in quantized_modules(self):
                _set_int8_(m, torch.zeros(m.weight.shape, dtype=torch.int8,
                                          device=m.weight.device),
                           torch.ones(m.weight.shape[0], device=m.weight.device))

    def forward(self, sample, timesteps, encoder_hidden_states, time_ids=None,
                text_embeds=None):
        """sample (B, H, W, in_channels) NHWC latents; timesteps (B,) or
        scalar; encoder_hidden_states (B, L, cross_dim); time_ids (B, 6) and
        text_embeds (B, pooled_dim) for 'text_time'. Returns NHWC."""
        cfg, dt = self.cfg, self.cfg.dtype
        b = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device).expand(b)
        emb = self.time_embedding(
            get_timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dt))
        if cfg.addition_embed_type == "text_time":
            aug = get_timestep_embedding(time_ids.reshape(-1), cfg.addition_time_embed_dim)
            aug = torch.cat([text_embeds.float(), aug.reshape(b, -1)], dim=-1)
            emb = emb + self.add_embedding(aug.to(dt))
        context = encoder_hidden_states.to(dt)
        x = conv_nhwc(self.conv_in, sample, dt)

        res_stack = [x]
        for block in self.down_blocks:
            for i, resnet in enumerate(block.resnets):
                x = resnet(x, emb)
                if len(block.attentions):
                    x = block.attentions[i](x, context)
                res_stack.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                res_stack.append(x)

        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, emb), context), emb)

        for block in self.up_blocks:
            for i, resnet in enumerate(block.resnets):
                x = resnet(torch.cat([x, res_stack.pop()], dim=-1), emb)
                if len(block.attentions):
                    x = block.attentions[i](x, context)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)

        x = F.silu(self.conv_norm_out(x)).to(dt)
        return conv_nhwc(self.conv_out, x, dt)
