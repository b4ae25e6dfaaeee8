"""SDXLAdapter (the visual de-tokenizer): ResamplerXLV2 conditioning for the
SDXL UNet; counterpart of ``seed_story_tpu/models/sdxl/adapter.py``. The
training forward is the eps-prediction MSE of stage 3; the trainable set is
the resampler and every UNet ``to_k`` / ``to_v`` projection (self- and
cross-attention), or the whole UNet with ``full_ft``. State-dict names:
``resampler.*`` and ``unet.*``, as ``convert_detokenizer`` reads them. The
adapter passes ``unet.quantize`` through to its UNet (the int8 UNet, for
inference); ``quantize_adapter_`` converts a float adapter's UNet in place."""

from __future__ import annotations

import dataclasses
from typing import Dict

from torch import nn

from ..ipa_resampler import ResamplerXLV2
from .unet import SDXLUNetConfig, UNet2DConditionModel, quantize_unet_


@dataclasses.dataclass(frozen=True)
class SDXLAdapterConfig:
    unet: SDXLUNetConfig = dataclasses.field(default_factory=SDXLUNetConfig)
    resampler_dim: int = 1024
    resampler_depth: int = 4
    resampler_heads: int = 16
    resampler_queries: int = 64
    embedding_dim: int = 4096  # ViT / agent feature dim
    output1_dim: int = 768
    output2_dim: int = 1280
    full_ft: bool = False  # training only

    @staticmethod
    def tiny(**kw) -> "SDXLAdapterConfig":
        unet = SDXLUNetConfig.tiny()
        base = dict(unet=unet, resampler_dim=32, resampler_depth=1, resampler_heads=2,
                    resampler_queries=8, embedding_dim=128, output1_dim=32,
                    output2_dim=unet.pooled_projection_dim)
        base.update(kw)
        return SDXLAdapterConfig(**base)


class SDXLAdapter(nn.Module):
    def __init__(self, cfg: SDXLAdapterConfig):
        super().__init__()
        self.cfg = cfg
        self.resampler = ResamplerXLV2(
            dim=cfg.resampler_dim, depth=cfg.resampler_depth, heads=cfg.resampler_heads,
            num_queries=cfg.resampler_queries, embedding_dim=cfg.embedding_dim,
            output1_dim=cfg.output1_dim, output2_dim=cfg.output2_dim, dtype=cfg.unet.dtype,
            param_dtype=cfg.unet.param_dtype)
        # the UNet's cross-attention reads the resampler's concatenated prompt
        # embeds (the JAX modules take that width from their input)
        self.unet = UNet2DConditionModel(dataclasses.replace(
            cfg.unet, cross_attention_dim=cfg.output1_dim + cfg.output2_dim))

    def forward(self, noisy_latents, timesteps, image_embeds, time_ids, noise):
        """Training forward: NHWC ``noisy_latents``, (B,) ``timesteps``,
        (B, n, embedding_dim) ``image_embeds``, (B, 6) ``time_ids``, the
        ``noise`` that was added. Returns {"total_loss" (the f32 MSE of the
        predicted noise), "noise_pred"}."""
        prompt_embeds, pooled = self.resampler(image_embeds)
        noise_pred = self.unet(noisy_latents, timesteps, prompt_embeds, time_ids=time_ids,
                               text_embeds=pooled)
        loss = (noise_pred.float() - noise.float()).square().mean()
        return {"total_loss": loss, "noise_pred": noise_pred}

    def encode_image_embeds(self, image_embeds):
        """(B, n, embedding_dim) -> (prompt_embeds (B, nq, 2048), pooled (B, 1280))."""
        return self.resampler(image_embeds)

    def denoise(self, noisy_latents, timesteps, prompt_embeds, pooled, time_ids):
        """UNet call with precomputed conditioning (NHWC latents)."""
        return self.unet(noisy_latents, timesteps, prompt_embeds, time_ids=time_ids,
                         text_embeds=pooled)


def adapter_trainable_mask(adapter: SDXLAdapter, full_ft: bool = False) -> Dict[str, bool]:
    """Parameter name -> whether it trains: the whole resampler and every UNet
    ``to_k`` / ``to_v`` (self- and cross-attention), or the whole UNet with
    ``full_ft``. The keys are those of ``adapter.named_parameters()``."""
    mask = {}
    for name, _ in adapter.named_parameters():
        parts = name.split(".")
        mask[name] = (parts[0] == "resampler" or (full_ft and parts[0] == "unet")
                      or "to_k" in parts or "to_v" in parts)
    return mask


def quantize_adapter_(adapter: SDXLAdapter) -> SDXLAdapter:
    """In place: the adapter's UNet becomes the int8 UNet (``quantize_unet_``)
    and its configuration says so; the resampler stays float."""
    quantize_unet_(adapter.unet)
    adapter.cfg = dataclasses.replace(adapter.cfg, unet=dataclasses.replace(adapter.cfg.unet,
                                                                             quantize=True))
    return adapter
