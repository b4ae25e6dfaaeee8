"""Text-encoder-free SDXL sampling (CFG + Euler) in PyTorch; counterpart of
``seed_story_tpu/pipelines/sdxl_pipeline.py``. Conditioning comes from
image features through ResamplerXLV2; the negatives are a black image's
features; the uncond/cond pair runs as one UNet batch."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.sdxl.schedulers import EulerDiscreteScheduler, SchedulerConfig


@dataclasses.dataclass
class SDXLSampleConfig:
    height: int = 1024
    width: int = 1024
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    latent_channels: int = 4
    vae_scale: int = 8  # spatial downscale of the VAE


class SDXLImagePipeline:
    def __init__(self, adapter, vae, scheduler: Optional[EulerDiscreteScheduler] = None,
                 cfg: SDXLSampleConfig = SDXLSampleConfig()):
        self.adapter = adapter
        self.vae = vae
        self.scheduler = scheduler or EulerDiscreteScheduler(SchedulerConfig())
        self.cfg = cfg

    @torch.inference_mode()
    def generate_pixels(self, image_embeds, neg_image_embeds, time_ids=None,
                        generator: Optional[torch.Generator] = None,
                        init_latents: Optional[np.ndarray] = None) -> torch.Tensor:
        """Returns pixels (B, H, W, 3) in [-1, 1] before clipping. The initial
        latents (B, H/8, W/8, 4) come from ``init_latents`` (already scaled by
        the initial sigma) or else from ``generator``."""
        cfg = self.cfg
        dev = next(self.adapter.parameters()).device
        ts, sigmas = self.scheduler.timesteps_and_sigmas(cfg.num_inference_steps)
        image_embeds = torch.as_tensor(image_embeds, device=dev)
        neg_image_embeds = torch.as_tensor(neg_image_embeds, device=dev)
        prompt, pooled = self.adapter.encode_image_embeds(image_embeds)
        nprompt, npooled = self.adapter.encode_image_embeds(neg_image_embeds)
        b = prompt.shape[0]
        if time_ids is None:
            time_ids = np.tile(np.array([[cfg.height, cfg.width, 0, 0, cfg.height, cfg.width]],
                                        np.float32), (b, 1))
        time_ids = torch.as_tensor(time_ids, dtype=torch.float32, device=dev)
        prompt2 = torch.cat([nprompt, prompt])
        pooled2 = torch.cat([npooled, pooled])
        time_ids2 = torch.cat([time_ids, time_ids])

        if init_latents is None:
            shape = (b, cfg.height // cfg.vae_scale, cfg.width // cfg.vae_scale,
                     cfg.latent_channels)
            latents = torch.randn(shape, generator=generator, device=dev,
                                  dtype=torch.float32) * self.scheduler.init_noise_sigma(sigmas)
        else:
            latents = torch.tensor(np.asarray(init_latents), dtype=torch.float32, device=dev)

        unet_dtype = self.adapter.cfg.unet.dtype
        sig = torch.as_tensor(sigmas, device=dev)
        for i in range(cfg.num_inference_steps):
            inp = EulerDiscreteScheduler.scale_model_input(latents, sig[i])
            t = torch.full((2 * b,), float(ts[i]), device=dev)
            eps2 = self.adapter.denoise(torch.cat([inp, inp]).to(unet_dtype), t, prompt2,
                                        pooled2, time_ids2).float()
            eps_u, eps_c = eps2.chunk(2)
            eps = eps_u + cfg.guidance_scale * (eps_c - eps_u)
            latents = EulerDiscreteScheduler.step(eps, sig[i], sig[i + 1], latents)
        return self.vae.decode(latents.to(self.vae.cfg.dtype))

    def generate(self, image_embeds, neg_image_embeds, time_ids=None,
                 generator: Optional[torch.Generator] = None,
                 init_latents: Optional[np.ndarray] = None) -> np.ndarray:
        """Returns uint8 images (B, H, W, 3)."""
        pixels = self.generate_pixels(image_embeds, neg_image_embeds, time_ids, generator,
                                      init_latents)
        pixels = pixels.float().cpu().numpy()
        return ((np.clip(pixels, -1, 1) + 1) * 127.5).astype(np.uint8)
