"""The plain float32 reference of the de-tokenizer: ResamplerXLV2 (the
conditioning from image features), the SDXL-base UNet (epsilon prediction,
added time and pooled conditioning), classifier-free guidance with the Euler
sampler's update, and the SDXL VAE's decoder.

Parameter names are diffusers' (``down_blocks.{i}.resnets.{j}.conv1``,
``...attentions.{j}.transformer_blocks.{k}.attn1.to_q``) and the released
resampler's (``layers.{i}.0.to_q``, ``unet_attnpool.c_proj``), which the
program keeps, so one seeded weight stream fills both. Tensors are NCHW
inside; the sampler's latents and the UNet's input and output are NHWC, as
the program hands them over.

One departure from diffusers' SDXL UNet, taken from the program under test:
its downsamplers pad the right and bottom by one and convolve with stride 2
and no padding (diffusers' UNet pads one on every side; its VAE encoder pads
as here).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import Lin, Norm, attention, fp8_round


class Conv(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1, pad: int = None):
        super().__init__()
        self.stride, self.pad = stride, (k // 2 if pad is None else pad)
        self.fp8 = False
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(c_out), requires_grad=False)

    def forward(self, x):
        return F.conv2d(fp8_round(x) if self.fp8 else x, self.weight, self.bias, self.stride,
                        self.pad)


class GN(nn.Module):
    def __init__(self, groups: int, c: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.empty(c), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(c), requires_grad=False)

    def forward(self, x):
        return F.group_norm(x, self.groups, self.weight, self.bias, self.eps)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' sinusoidal embedding, cos first, no shift."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                      device=t.device) / half)
    emb = t.float()[:, None] * freqs[None]
    return torch.cat([emb.cos(), emb.sin()], dim=-1)


class Resnet(nn.Module):
    def __init__(self, c_in: int, c_out: int, groups: int, eps: float, temb: int = 0):
        super().__init__()
        self.norm1, self.conv1 = GN(groups, c_in, eps), Conv(c_in, c_out, 3)
        self.time_emb_proj = Lin(temb, c_out) if temb else None
        self.norm2, self.conv2 = GN(groups, c_out, eps), Conv(c_out, c_out, 3)
        self.conv_shortcut = Conv(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Attn(nn.Module):
    def __init__(self, dim: int, ctx: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q, self.to_k = Lin(dim, dim, bias=False), Lin(ctx, dim, bias=False)
        self.to_v = Lin(ctx, dim, bias=False)
        self.to_out = nn.ModuleList([Lin(dim, dim)])

    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        b, lq, d = x.shape
        hd = d // self.heads

        def split(t):
            return t.view(b, t.shape[1], self.heads, hd).transpose(1, 2)

        o = attention(split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)))
        return self.to_out[0](o.transpose(1, 2).reshape(b, lq, d))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Lin(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class Block(nn.Module):
    def __init__(self, dim: int, ctx: int, heads: int):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = (Norm(dim, 1e-6) for _ in range(3))
        self.attn1, self.attn2 = Attn(dim, dim, heads), Attn(dim, ctx, heads)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), Lin(4 * dim, dim)])

    def forward(self, x, ctx):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx)
        return x + self.ff.net[2](self.ff.net[0](self.norm3(x)))


class Transformer(nn.Module):
    def __init__(self, c: int, depth: int, ctx: int, head_dim: int, groups: int):
        super().__init__()
        self.norm = GN(groups, c, 1e-6)
        self.proj_in, self.proj_out = Lin(c, c), Lin(c, c)
        self.transformer_blocks = nn.ModuleList(Block(c, ctx, c // head_dim)
                                                for _ in range(depth))

    def forward(self, x, ctx):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for blk in self.transformer_blocks:
            y = blk(y, ctx)
        return x + self.proj_out(y).reshape(b, h, w, c).permute(0, 3, 1, 2)


class Down(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c, 3, stride=2, pad=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Up(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Stage(nn.Module):
    def __init__(self, resnets, attentions, sampler=None, sampler_name="downsamplers"):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList(attentions)
        if sampler is not None:
            self.add_module(sampler_name, nn.ModuleList([sampler]))


class TimeMLP(nn.Module):
    def __init__(self, n_in: int, dim: int):
        super().__init__()
        self.linear_1, self.linear_2 = Lin(n_in, dim), Lin(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet(nn.Module):
    """SDXL-base's UNet2DConditionModel from its unet/config.json keys."""

    def __init__(self, u: dict):
        super().__init__()
        self.u = u
        ch, g = u["block_out_channels"], u["norm_num_groups"]
        hd, ctx = u["attention_head_size"], u["cross_attention_dim"]
        depth, per = u["transformer_layers_per_block"], u["layers_per_block"]
        temb = 4 * ch[0]
        self.time_embedding = TimeMLP(ch[0], temb)
        self.add_embedding = TimeMLP(u["projection_class_embeddings_input_dim"], temb)
        self.conv_in = Conv(u["in_channels"], ch[0], 3)
        skip, c_in = [ch[0]], ch[0]
        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(u["down_block_types"]):
            res, att = [], []
            for _ in range(per):
                res.append(Resnet(c_in, ch[i], g, 1e-5, temb))
                c_in = ch[i]
                if "CrossAttn" in kind:
                    att.append(Transformer(ch[i], depth[i], ctx, hd, g))
                skip.append(c_in)
            sampler = Down(ch[i]) if i < len(ch) - 1 else None
            if sampler is not None:
                skip.append(c_in)
            self.down_blocks.append(Stage(res, att, sampler))
        self.mid_block = Stage([Resnet(ch[-1], ch[-1], g, 1e-5, temb) for _ in range(2)],
                               [Transformer(ch[-1], depth[-1], ctx, hd, g)])
        self.up_blocks = nn.ModuleList()
        up_ch, up_depth = ch[::-1], depth[::-1]
        for i, kind in enumerate(u["up_block_types"]):
            res, att = [], []
            for _ in range(per + 1):
                res.append(Resnet(c_in + skip.pop(), up_ch[i], g, 1e-5, temb))
                c_in = up_ch[i]
                if "CrossAttn" in kind:
                    att.append(Transformer(up_ch[i], up_depth[i], ctx, hd, g))
            sampler = Up(up_ch[i]) if i < len(ch) - 1 else None
            self.up_blocks.append(Stage(res, att, sampler, "upsamplers"))
        self.conv_norm_out = GN(g, ch[0], 1e-5)
        self.conv_out = Conv(ch[0], u["out_channels"], 3)

    def forward(self, sample, t, ctx, pooled, time_ids):
        """sample (B, H, W, 4) NHWC, t (B,), ctx (B, L, cross), pooled (B,
        1280), time_ids (B, 6) -> eps (B, H, W, 4)."""
        u = self.u
        b = sample.shape[0]
        emb = self.time_embedding(timestep_embedding(t, u["block_out_channels"][0]))
        aug = timestep_embedding(time_ids.reshape(-1), u["addition_time_embed_dim"])
        emb = emb + self.add_embedding(torch.cat([pooled, aug.reshape(b, -1)], dim=-1))
        x = self.conv_in(sample.permute(0, 3, 1, 2))
        stack = [x]
        for blk in self.down_blocks:
            for i, res in enumerate(blk.resnets):
                x = res(x, emb)
                if len(blk.attentions):
                    x = blk.attentions[i](x, ctx)
                stack.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                stack.append(x)
        m = self.mid_block
        x = m.resnets[1](m.attentions[0](m.resnets[0](x, emb), ctx), emb)
        for blk in self.up_blocks:
            for i, res in enumerate(blk.resnets):
                x = res(torch.cat([x, stack.pop()], dim=1), emb)
                if len(blk.attentions):
                    x = blk.attentions[i](x, ctx)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x))).permute(0, 2, 3, 1)


# --- the conditioning --------------------------------------------------------

class Perceiver(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int = 64):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.norm1, self.norm2 = Norm(dim, 1e-5), Norm(dim, 1e-5)
        inner = heads * dim_head
        self.to_q, self.to_kv = Lin(dim, inner, bias=False), Lin(dim, 2 * inner, bias=False)
        self.to_out = Lin(inner, dim, bias=False)

    def forward(self, x, latents):
        x, latents = self.norm1(x), self.norm2(latents)
        b, n, _ = latents.shape
        k, v = self.to_kv(torch.cat([x, latents], dim=1)).chunk(2, dim=-1)

        def split(t):
            return t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)

        o = attention(split(self.to_q(latents)), split(k), split(v),
                      scale=1.0 / math.sqrt(self.dim_head))
        return self.to_out(o.transpose(1, 2).reshape(b, n, -1))


class FeedForward(nn.Sequential):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__(Norm(dim, 1e-5), Lin(dim, dim * mult, bias=False), nn.GELU(),
                         Lin(dim * mult, dim, bias=False))


class AttnPool(nn.Module):
    def __init__(self, n: int, dim: int, heads: int, out: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(torch.empty(n + 1, dim), requires_grad=False)
        self.q_proj, self.k_proj, self.v_proj = Lin(dim, dim), Lin(dim, dim), Lin(dim, dim)
        self.c_proj = Lin(dim, out)

    def forward(self, x):
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1) + self.positional_embedding[None]
        b, n, e = x.shape
        hd = e // self.heads

        def split(t):
            return t.reshape(b, t.shape[1], self.heads, hd).transpose(1, 2)

        o = attention(split(self.q_proj(x[:, :1])), split(self.k_proj(x)), split(self.v_proj(x)))
        return self.c_proj(o.transpose(1, 2).reshape(b, 1, e))[:, 0]


class ResamplerXLV2(nn.Module):
    """Image features (B, n, 4096), L2-normalized over the token axis (the
    released model's ``F.normalize`` with its default dim=1) -> prompt
    embeds (B, queries, 768 + 1280) and pooled (B, 1280)."""

    def __init__(self, r: dict):
        super().__init__()
        dim = r["dim"]
        self.latents = nn.Parameter(torch.empty(1, r["queries"], dim), requires_grad=False)
        self.proj_in = Lin(r["embedding_dim"], dim)
        self.layers = nn.ModuleList(nn.ModuleList([Perceiver(dim, r["heads"]), FeedForward(dim)])
                                    for _ in range(r["depth"]))
        self.norm_out = Norm(dim, 1e-5)
        self.unet_proj_1, self.unet_proj_2 = Lin(dim, r["output1_dim"]), Lin(dim, r["output2_dim"])
        self.unet_attnpool = AttnPool(r["queries"], dim, r["heads"], r["output2_dim"])

    def forward(self, x):
        x = x / x.square().sum(dim=1, keepdim=True).sqrt().clamp(min=1e-12)
        x = self.proj_in(x)
        lat = self.latents.expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            lat = attn(x, lat) + lat
            lat = ff(lat) + lat
        h = self.norm_out(lat)
        return torch.cat([self.unet_proj_1(h), self.unet_proj_2(h)], dim=-1), self.unet_attnpool(h)


class Adapter(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.resampler = ResamplerXLV2(c["resampler"])
        self.unet = UNet(c)


# --- the VAE decoder ------------------------------------------------------

class VAEAttention(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = GN(groups, c, 1e-6)
        self.to_q, self.to_k, self.to_v = Lin(c, c), Lin(c, c), Lin(c, c)
        self.to_out = nn.ModuleList([Lin(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, 1, h * w, c)
        o = attention(self.to_q(y), self.to_k(y), self.to_v(y), rows=1)
        return x + self.to_out[0](o).reshape(b, h, w, c).permute(0, 3, 1, 2)


class Decoder(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        ch, g, per = v["block_out_channels"][::-1], v["norm_num_groups"], v["layers_per_block"]
        self.conv_in = Conv(v["latent_channels"], ch[0], 3)
        self.mid_block = Stage([Resnet(ch[0], ch[0], g, 1e-6) for _ in range(2)],
                               [VAEAttention(ch[0], g)])
        self.up_blocks = nn.ModuleList()
        c_in = ch[0]
        for i, c in enumerate(ch):
            res = []
            for _ in range(per + 1):
                res.append(Resnet(c_in, c, g, 1e-6))
                c_in = c
            self.up_blocks.append(Stage(res, [], Up(c) if i < len(ch) - 1 else None, "upsamplers"))
        self.conv_norm_out = GN(g, ch[-1], 1e-6)
        self.conv_out = Conv(ch[-1], v["in_channels"], 3)

    def forward(self, z):
        m = self.mid_block
        x = m.resnets[1](m.attentions[0](m.resnets[0](self.conv_in(z))))
        for blk in self.up_blocks:
            for res in blk.resnets:
                x = res(x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAE(nn.Module):
    """The decoding half of AutoencoderKL under diffusers' names."""

    def __init__(self, v: dict):
        super().__init__()
        self.v = v
        self.decoder = Decoder(v)
        self.post_quant_conv = Conv(v["latent_channels"], v["latent_channels"], 1)

    def decode(self, latents):
        """(B, h, w, 4) scaled latents -> (B, H, W, 3) pixels before clipping."""
        z = latents.permute(0, 3, 1, 2) / self.v["scaling_factor"]
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)


# --- the sampler ------------------------------------------------------------

def euler_schedule(steps: int, s: dict):
    """(timesteps (n,), sigmas (n + 1,) ending in 0) of the Euler sampler:
    scaled-linear betas, 'leading' spacing with steps_offset, sigmas
    interpolated linearly over the training timesteps."""
    betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5,
                        s["num_train_timesteps"], dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas).astype(np.float32).astype(np.float64)
    train_sigmas = np.sqrt((1.0 - acp) / acp)
    ratio = s["num_train_timesteps"] // steps
    ts = (np.arange(steps) * ratio).round()[::-1].astype(np.float64) + s["steps_offset"]
    sigmas = np.interp(ts, np.arange(s["num_train_timesteps"]), train_sigmas)
    return ts.astype(np.float32), np.concatenate([sigmas, [0.0]]).astype(np.float32)


def euler_step(latents, eps_uncond, eps_cond, guidance: float, sigma: float, sigma_next: float):
    """Classifier-free guidance, then one Euler step of the epsilon ODE."""
    eps = eps_uncond + guidance * (eps_cond - eps_uncond)
    return latents + eps * (sigma_next - sigma)
