"""IP-Adapter attention and the auxiliary adapters in PyTorch; counterpart of
``seed_story_tpu/models/ipa_adapters.py``.

``IPCrossAttention`` is the decoupled cross-attention (text K/V from
``to_k`` / ``to_v``, image K/V from ``to_k_ip`` / ``to_v_ip``, output
``text + scale * image``). ``IPAdapterSD`` conditions an SD-1.5-layout UNet
on [text; image tokens] in one context, the image tokens from
``IPAResampler``. ``SDXLAdapterWithLatentImage`` and
``SD21Text2ImageAndEditAdapter`` condition an 8-channel UNet on a latent
image concatenated on the channel axis. State-dict names:
``image_proj_model.*`` / ``resampler.*`` (the reference resampler's names)
and ``unet.*`` (diffusers names). Attention goes through ``ops.attention.mha``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..ops.attention import mha
from ..ops.dense import linear
from .ipa_resampler import IPAResampler
from .sdxl.unet import SDXLUNetConfig, UNet2DConditionModel


def _eps_mse(noise_pred, noise):
    return (noise_pred.float() - noise.float()).square().mean()


class IPCrossAttention(nn.Module):
    """Decoupled cross-attention: the encoder states are [text tokens
    (``text_context_len``); image tokens]; each part has its own K/V
    projections, and the image part's output is added times ``scale``.
    ``context_dim`` is the encoder states' width (default ``query_dim``)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int, text_context_len: int = 77,
                 scale: float = 1.0, context_dim: Optional[int] = None,
                 dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.text_context_len = heads, dim_head, text_context_len
        self.scale, self.dtype = scale, dtype
        inner, context_dim = heads * dim_head, context_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False, dtype=param_dtype)
        self.to_k = nn.Linear(context_dim, inner, bias=False, dtype=param_dtype)
        self.to_v = nn.Linear(context_dim, inner, bias=False, dtype=param_dtype)
        self.to_k_ip = nn.Linear(context_dim, inner, bias=False, dtype=param_dtype)
        self.to_v_ip = nn.Linear(context_dim, inner, bias=False, dtype=param_dtype)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, dtype=param_dtype)])

    def forward(self, x, encoder_hidden_states):
        dt, h, hd = self.dtype, self.heads, self.dim_head
        b, lq, _ = x.shape
        text = encoder_hidden_states[:, :self.text_context_len]
        image = encoder_hidden_states[:, self.text_context_len:]

        def heads_first(layer, t):
            return linear(layer, t, dt).view(b, t.shape[1], h, hd).transpose(1, 2)

        q = heads_first(self.to_q, x)
        out_t = mha(q, heads_first(self.to_k, text), heads_first(self.to_v, text), causal=False)
        out_i = mha(q, heads_first(self.to_k_ip, image), heads_first(self.to_v_ip, image),
                    causal=False)
        out = (out_t + self.scale * out_i).transpose(1, 2).reshape(b, lq, h * hd)
        return linear(self.to_out[0], out, dt)


def sd15_unet_config(**kw) -> SDXLUNetConfig:
    """The SD-1.5 / SD-2.1 UNet layout at the port's dtypes: four blocks
    with a trailing ``DownBlock2D``, ``UpBlock2D`` first, one transformer
    layer a block, no added conditioning."""
    base = dict(block_out_channels=(320, 640, 1280, 1280),
                down_block_types=("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",),
                up_block_types=("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3,
                transformer_layers_per_block=(1, 1, 1, 1), cross_attention_dim=768,
                addition_embed_type=None)
    base.update(kw)
    return SDXLUNetConfig(**base)


@dataclasses.dataclass(frozen=True)
class IPAdapterConfig:
    unet: SDXLUNetConfig = dataclasses.field(default_factory=sd15_unet_config)
    image_embedding_dim: int = 1024  # CLIP image embed
    num_image_tokens: int = 4
    resampler_depth: int = 4
    scale: float = 1.0


class IPAdapterSD(nn.Module):
    """IP-Adapter for an SD-1.5-layout UNet: ``IPAResampler`` projects the
    image embeds to ``num_image_tokens`` prompt tokens appended after the
    text context (the image tokens extend the context; the decoupled K/V
    variant is :class:`IPCrossAttention`)."""

    def __init__(self, cfg: IPAdapterConfig):
        super().__init__()
        self.cfg = cfg
        u = cfg.unet
        self.image_proj_model = IPAResampler(
            dim=u.cross_attention_dim, depth=cfg.resampler_depth,
            num_queries=cfg.num_image_tokens, embedding_dim=cfg.image_embedding_dim,
            output_dim=u.cross_attention_dim, dtype=u.dtype, param_dtype=u.param_dtype)
        self.unet = UNet2DConditionModel(u)

    def forward(self, noisy_latents, timesteps, text_embeds, image_embeds, noise):
        """Training forward: the eps-MSE with [text; image tokens] context.
        Returns {"total_loss" (f32), "noise_pred"}."""
        image_tokens = self.image_proj_model(image_embeds)
        context = torch.cat([text_embeds.to(image_tokens.dtype), image_tokens], dim=1)
        noise_pred = self.unet(noisy_latents, timesteps, context)
        return {"total_loss": _eps_mse(noise_pred, noise), "noise_pred": noise_pred}

    def encode_image_embeds(self, image_embeds):
        """image embeds -> ``num_image_tokens`` prompt tokens."""
        return self.image_proj_model(image_embeds)

    def denoise(self, noisy_latents, timesteps, context):
        """One eps prediction with a built [text; image] context."""
        return self.unet(noisy_latents, timesteps, context)


@dataclasses.dataclass(frozen=True)
class EditAdapterConfig:
    """The SDXL text2image + edit adapter: an 8-channel ``conv_in`` (latent
    + latent-image condition)."""

    unet: SDXLUNetConfig = dataclasses.field(
        default_factory=lambda: SDXLUNetConfig(in_channels=8))
    lora_rank: int = 16


class SDXLAdapterWithLatentImage(nn.Module):
    """Conditions the SDXL UNet on a latent image concatenated on the
    channel axis. ``resampler`` is kept for the reference's signature and
    not called."""

    def __init__(self, cfg: EditAdapterConfig, resampler: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        self.resampler = resampler
        self.unet = UNet2DConditionModel(cfg.unet)

    def forward(self, noisy_latents, latent_image, timesteps, prompt_embeds, pooled, time_ids,
                noise):
        x = torch.cat([noisy_latents, latent_image], dim=-1)
        noise_pred = self.unet(x, timesteps, prompt_embeds, time_ids=time_ids, text_embeds=pooled)
        return {"total_loss": _eps_mse(noise_pred, noise), "noise_pred": noise_pred}


@dataclasses.dataclass(frozen=True)
class SD21EditAdapterConfig:
    """The SD-2.1 text2image + edit adapter: the SD-2.x UNet (cross-attention
    width 1024, no added conditioning) with an 8-channel ``conv_in`` (noisy
    latents and the latent image concatenated)."""

    unet: SDXLUNetConfig = dataclasses.field(
        default_factory=lambda: sd15_unet_config(in_channels=8, cross_attention_dim=1024))
    lora_rank: int = 16


class SD21Text2ImageAndEditAdapter(nn.Module):
    """The optional ``resampler`` turns the text embeds into prompt embeds
    (a tuple's first element; none: the text embeds are the prompt), then
    the UNet's eps prediction over the 8-channel latents under the mean
    eps-MSE. ``image_embeds`` is taken for the reference's signature and
    unused. Its trainable set is :func:`sd21_edit_trainable_mask`."""

    def __init__(self, cfg: SD21EditAdapterConfig, resampler: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        self.resampler = resampler
        self.unet = UNet2DConditionModel(cfg.unet)

    def encode_text_embeds(self, text_embeds):
        if self.resampler is None:
            return text_embeds
        out = self.resampler(text_embeds)
        return out[0] if isinstance(out, tuple) else out

    def forward(self, noisy_latents, timesteps, image_embeds, text_embeds, noise):
        del image_embeds
        noise_pred = self.unet(noisy_latents, timesteps, self.encode_text_embeds(text_embeds))
        return {"total_loss": _eps_mse(noise_pred, noise), "noise_pred": noise_pred}

    def denoise(self, noisy_latents, timesteps, prompt_embeds):
        return self.unet(noisy_latents, timesteps, prompt_embeds)


def sd21_edit_trainable_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> trainable, for the port's ``Trainer``: the
    resampler, the UNet's ``conv_in``, every resnet and downsampler of the
    down blocks without attention (``DownBlock2D``), and the ``to_q`` /
    ``to_out`` projections of every attention (the reference's LoRA
    targets, trained directly as in the JAX package)."""
    plain_down = tuple(f"unet.down_blocks.{bi}.{part}."
                       for bi, kind in enumerate(model.cfg.unet.down_block_types)
                       if "CrossAttn" not in kind for part in ("resnets", "downsamplers"))

    def trains(name: str) -> bool:
        return (name.startswith(("resampler.", "unet.conv_in.") + plain_down)
                or ".to_q." in name or ".to_out.0." in name)

    return {name: trains(name) for name, _ in model.named_parameters()}
