"""IP-Adapter SD-1.5 sampling in PyTorch; counterpart of
``seed_story_tpu/pipelines/ipa_pipeline.py``.

An image goes through the injected visual encoder and discrete-model encode
to the IP-Adapter's image tokens; the CFG negatives are the tokens of a
zero image; the text embeds come from an injected ``encode_text`` and are
concatenated with the image tokens (times ``scale``) into one context. The
Euler loop runs the [uncond; cond] pair as one UNet batch, then the VAE
decodes and the images come back as uint8.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models.sdxl.schedulers import EulerDiscreteScheduler, SchedulerConfig


@dataclasses.dataclass
class IPASampleConfig:
    height: int = 512
    width: int = 512
    num_inference_steps: int = 30
    guidance_scale: float = 7.5
    latent_channels: int = 4
    vae_scale: int = 8


class IPAdapterSDPipeline:
    def __init__(self, ip_adapter, vae, encode_text: Callable[[Any], Any],
                 visual_encode: Optional[Callable] = None,
                 encode_discrete: Optional[Callable] = None,
                 scheduler: Optional[EulerDiscreteScheduler] = None,
                 cfg: IPASampleConfig = IPASampleConfig()):
        """``encode_text``: prompts -> (B, 77, cross_dim) embeds;
        ``visual_encode``: (B, 3, H, W) pixels -> image features;
        ``encode_discrete``: features -> the IP-Adapter's image embeds (a
        discrete model's ``encode_image_embeds``; default the identity)."""
        self.ip_adapter = ip_adapter
        self.vae = vae
        self.encode_text = encode_text
        self.visual_encode = visual_encode
        self.encode_discrete = encode_discrete or (lambda e: e)
        self.scheduler = scheduler or EulerDiscreteScheduler(SchedulerConfig())
        self.cfg = cfg
        self.device = next(ip_adapter.parameters()).device

    def _tokens(self, image_tensor):
        embeds = self.encode_discrete(self.visual_encode(image_tensor))
        return self.ip_adapter.encode_image_embeds(torch.as_tensor(embeds, device=self.device))

    @torch.inference_mode()
    def get_image_embeds(self, image_tensor, return_negative: bool = True):
        """Image pixels -> the IP-Adapter's prompt tokens, and those of a
        zero image as the negatives."""
        image_tensor = torch.as_tensor(image_tensor, device=self.device)
        tok = self._tokens(image_tensor)
        neg = self._tokens(torch.zeros_like(image_tensor)) if return_negative else None
        return tok, neg

    @torch.inference_mode()
    def generate_pixels(self, ctx_pos, ctx_neg, generator: Optional[torch.Generator] = None,
                        init_latents=None) -> torch.Tensor:
        """The CFG Euler loop over one (2B, L, D) context batch and the VAE
        decode: pixels (B, H, W, 3) before clipping. The initial latents (B,
        H/8, W/8, 4) come from ``init_latents`` (already scaled by the initial
        sigma) or else from ``generator``."""
        cfg, dev = self.cfg, self.device
        ts, sigmas = self.scheduler.timesteps_and_sigmas(cfg.num_inference_steps)
        b = ctx_pos.shape[0]
        ctx2 = torch.cat([ctx_neg, ctx_pos])
        if init_latents is None:
            shape = (b, cfg.height // cfg.vae_scale, cfg.width // cfg.vae_scale,
                     cfg.latent_channels)
            latents = torch.randn(shape, generator=generator, device=dev,
                                  dtype=torch.float32) * self.scheduler.init_noise_sigma(sigmas)
        else:
            latents = torch.tensor(np.asarray(init_latents), dtype=torch.float32, device=dev)
        unet_dtype = self.ip_adapter.cfg.unet.dtype
        sig = torch.as_tensor(sigmas, device=dev)
        for i in range(cfg.num_inference_steps):
            inp = EulerDiscreteScheduler.scale_model_input(latents, sig[i])
            t = torch.full((2 * b,), float(ts[i]), device=dev)
            eps2 = self.ip_adapter.denoise(torch.cat([inp, inp]).to(unet_dtype), t, ctx2).float()
            eps_u, eps_c = eps2.chunk(2)
            eps = eps_u + cfg.guidance_scale * (eps_c - eps_u)
            latents = EulerDiscreteScheduler.step(eps, sig[i], sig[i + 1], latents)
        return self.vae.decode(latents.to(self.vae.cfg.dtype))

    @torch.inference_mode()
    def generate(self, image_tensor, prompt=None, negative_prompt=None, scale: float = 1.0,
                 seed: int = 42, init_latents=None) -> np.ndarray:
        """Returns uint8 images (B, H, W, 3) for the (B, 3, H, W) condition
        image. The initial latents are drawn from a generator seeded with
        ``seed`` on the pipeline's device, or given as ``init_latents``."""
        b = image_tensor.shape[0]
        if prompt is None:
            prompt = ""
        if negative_prompt is None:  # the reference's default negative
            negative_prompt = "monochrome, lowres, bad anatomy, worst quality, low quality"
        prompt = prompt if isinstance(prompt, list) else [prompt] * b
        negative_prompt = (negative_prompt if isinstance(negative_prompt, list)
                           else [negative_prompt] * b)
        tok, neg_tok = self.get_image_embeds(image_tensor)
        text_pos = torch.as_tensor(self.encode_text(prompt), device=self.device)
        text_neg = torch.as_tensor(self.encode_text(negative_prompt), device=self.device)
        ctx_pos = torch.cat([text_pos.to(tok.dtype), scale * tok], dim=1)
        ctx_neg = torch.cat([text_neg.to(tok.dtype), scale * neg_tok], dim=1)
        generator = None
        if init_latents is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        pixels = self.generate_pixels(ctx_pos, ctx_neg, generator, init_latents)
        pixels = pixels.float().cpu().numpy()
        return ((np.clip(pixels, -1, 1) + 1) * 127.5).astype(np.uint8)
