"""SDXL VAE (AutoencoderKL) in PyTorch, NHWC at the boundary; counterpart of
``seed_story_tpu/models/sdxl/vae.py``. ``encode`` turns the training targets
into latents (stage 3), ``decode`` turns latents into pixels. Names follow
diffusers (``encoder.down_blocks.{i}.resnets.{j}``,
``encoder.down_blocks.{i}.downsamplers.0.conv``, ``quant_conv``,
``decoder.up_blocks.{i}.resnets.{j}``, ``post_quant_conv``). The mid-block
attention is a plain f32 softmax, as in the JAX package: at 1024x1024 its
(16384, 16384) f32 scores take 1 GiB an image, so encode under
``torch.no_grad()``."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dense import linear
from ...ops.groupnorm import FastGroupNorm
from .unet import Downsample2D, UNetBlock, conv_nhwc, upsample_nearest_2x


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**kw) -> "VAEConfig":
        base = dict(block_out_channels=(16, 32), norm_num_groups=8, dtype=torch.float32)
        base.update(kw)
        return VAEConfig(**base)


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, cfg: VAEConfig):
        super().__init__()
        self.dtype = cfg.dtype
        pd, g = cfg.param_dtype, cfg.norm_num_groups
        self.norm1 = FastGroupNorm(g, in_channels, 1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, dtype=pd)
        self.norm2 = FastGroupNorm(g, out_channels, 1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, dtype=pd)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1, dtype=pd)
                              if in_channels != out_channels else None)

    def forward(self, x):
        dt = self.dtype
        h = conv_nhwc(self.conv1, F.silu(self.norm1(x)), dt)
        h = conv_nhwc(self.conv2, F.silu(self.norm2(h)), dt)
        if self.conv_shortcut is not None:
            x = conv_nhwc(self.conv_shortcut, x, dt)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial positions."""

    def __init__(self, channels: int, cfg: VAEConfig):
        super().__init__()
        self.dtype = cfg.dtype
        pd = cfg.param_dtype
        self.group_norm = FastGroupNorm(cfg.norm_num_groups, channels, 1e-6)
        self.to_q = nn.Linear(channels, channels, dtype=pd)
        self.to_k = nn.Linear(channels, channels, dtype=pd)
        self.to_v = nn.Linear(channels, channels, dtype=pd)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, dtype=pd)])

    def forward(self, x):
        dt = self.dtype
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = (linear(m, y, dt).float() for m in (self.to_q, self.to_k, self.to_v))
        attn = torch.softmax((q @ k.transpose(1, 2)) / math.sqrt(c), dim=-1)
        y = linear(self.to_out[0], (attn @ v).to(dt), dt)
        return x + y.reshape(b, h, w, c)


class Upsampler(nn.Module):
    def __init__(self, channels: int, cfg: VAEConfig):
        super().__init__()
        self.dtype = cfg.dtype
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, dtype=cfg.param_dtype)

    def forward(self, x):
        return conv_nhwc(self.conv, upsample_nearest_2x(x), self.dtype)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.dtype = cfg.dtype
        ch = cfg.block_out_channels
        pd = cfg.param_dtype
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1, dtype=pd)
        self.down_blocks = nn.ModuleList()
        c_in = ch[0]
        for bi, c in enumerate(ch):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(VAEResnet(c_in, c, cfg))
                c_in = c
            # pads right and bottom by one, then a stride-2 3x3 conv without padding
            sampler = Downsample2D(c, cfg) if bi < len(ch) - 1 else None
            self.down_blocks.append(UNetBlock(resnets, [], sampler, "downsamplers"))
        self.mid_block = UNetBlock([VAEResnet(ch[-1], ch[-1], cfg),
                                    VAEResnet(ch[-1], ch[-1], cfg)],
                                   [VAEAttention(ch[-1], cfg)])
        self.conv_norm_out = FastGroupNorm(cfg.norm_num_groups, ch[-1], 1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1, dtype=pd)

    def forward(self, x):
        dt = self.dtype
        x = conv_nhwc(self.conv_in, x, dt)
        for block in self.down_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))
        x = F.silu(self.conv_norm_out(x)).to(dt)
        return conv_nhwc(self.conv_out, x, dt)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.dtype = cfg.dtype
        ch = list(reversed(cfg.block_out_channels))
        pd = cfg.param_dtype
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[0], 3, padding=1, dtype=pd)
        self.mid_block = UNetBlock([VAEResnet(ch[0], ch[0], cfg), VAEResnet(ch[0], ch[0], cfg)],
                                   [VAEAttention(ch[0], cfg)])
        self.up_blocks = nn.ModuleList()
        c_in = ch[0]
        for bi, c in enumerate(ch):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(VAEResnet(c_in, c, cfg))
                c_in = c
            sampler = Upsampler(c, cfg) if bi < len(ch) - 1 else None
            self.up_blocks.append(UNetBlock(resnets, [], sampler, "upsamplers"))
        self.conv_norm_out = FastGroupNorm(cfg.norm_num_groups, ch[-1], 1e-6)
        self.conv_out = nn.Conv2d(ch[-1], cfg.in_channels, 3, padding=1, dtype=pd)

    def forward(self, z):
        dt = self.dtype
        x = conv_nhwc(self.conv_in, z, dt)
        mid = self.mid_block
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x)))
        for block in self.up_blocks:
            for resnet in block.resnets:
                x = resnet(x)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        x = F.silu(self.conv_norm_out(x)).to(dt)
        return conv_nhwc(self.conv_out, x, dt)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1,
                                    dtype=cfg.param_dtype)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1,
                                         dtype=cfg.param_dtype)

    def latent_shape(self, pixel_shape) -> Tuple[int, int, int, int]:
        """(B, H, W, 3) pixels -> the (B, h, w, latent_channels) shape of
        their latents (H and W divisible by the downsampling factor)."""
        f = 2 ** (len(self.cfg.block_out_channels) - 1)
        b, h, w, _ = pixel_shape
        return b, h // f, w // f, self.cfg.latent_channels

    def encode(self, pixels, eps=None):
        """pixels (B, H, W, 3) in [-1, 1] -> latents * scaling_factor.
        With ``eps`` (a standard normal draw of the latents' shape, f32) the
        latents are sampled from the posterior, else its mode."""
        dt = self.cfg.dtype
        moments = conv_nhwc(self.quant_conv, self.encoder(pixels), dt)
        mean, logvar = moments.chunk(2, dim=-1)
        if eps is not None:
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0).float())
            mean = mean + (std * eps).to(mean.dtype)
        return mean * self.cfg.scaling_factor

    def decode(self, latents):
        """latents (B, h, w, 4) scaled -> pixels (B, H, W, 3) in [-1, 1]."""
        z = latents / self.cfg.scaling_factor
        return self.decoder(conv_nhwc(self.post_quant_conv, z, self.cfg.dtype))
