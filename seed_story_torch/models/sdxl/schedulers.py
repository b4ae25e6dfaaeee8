"""Diffusion schedules for SDXL (scaled-linear betas 0.00085 -> 0.012 over
1000 steps, epsilon prediction); counterparts of the two schedulers in
``seed_story_tpu/models/sdxl/schedulers.py``: ``DDPMScheduler`` adds the
training noise of stage 3, ``EulerDiscreteScheduler`` samples ('leading'
spacing with steps_offset 1, linear sigma interpolation)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    steps_offset: int = 1
    timestep_spacing: str = "leading"


def alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                            cfg.num_train_timesteps, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.num_train_timesteps,
                            dtype=np.float64)
    else:
        raise ValueError(cfg.beta_schedule)
    return np.cumprod(1.0 - betas).astype(np.float32)


class DDPMScheduler:
    """Training-side q(x_t | x_0) sampling."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        self.alphas_cumprod = torch.from_numpy(alphas_cumprod(cfg))  # f32

    def add_noise(self, sample, noise, timesteps):
        """sample, noise: (B, ...); timesteps: (B,) int. Computed in f32,
        returned in the sample's dtype."""
        acp = self.alphas_cumprod.to(sample.device)[timesteps.long()]
        shape = (-1,) + (1,) * (sample.ndim - 1)
        sqrt_acp = torch.sqrt(acp).reshape(shape)
        sqrt_1macp = torch.sqrt(1.0 - acp).reshape(shape)
        return (sqrt_acp * sample.float() + sqrt_1macp * noise.float()).to(sample.dtype)

    def sample_timesteps(self, batch: int, generator: torch.Generator):
        """(batch,) int32 timesteps, uniform in [0, num_train_timesteps), on
        the generator's device."""
        return torch.randint(0, self.cfg.num_train_timesteps, (batch,), generator=generator,
                             dtype=torch.int32, device=generator.device)


class EulerDiscreteScheduler:
    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        acp = alphas_cumprod(cfg).astype(np.float64)
        self._train_sigmas = np.sqrt((1.0 - acp) / acp)

    def timesteps_and_sigmas(self, num_inference_steps: int) -> Tuple[np.ndarray, np.ndarray]:
        """(timesteps (n,) f32, sigmas (n + 1,) f32 ending in 0)."""
        cfg = self.cfg
        if cfg.timestep_spacing == "leading":
            step_ratio = cfg.num_train_timesteps // num_inference_steps
            ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].astype(np.float64)
            ts += cfg.steps_offset
        elif cfg.timestep_spacing == "linspace":
            ts = np.linspace(0, cfg.num_train_timesteps - 1, num_inference_steps,
                             dtype=np.float64)[::-1]
        else:
            raise ValueError(cfg.timestep_spacing)
        sigmas = np.interp(ts, np.arange(cfg.num_train_timesteps), self._train_sigmas)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        return ts.astype(np.float32), sigmas

    @staticmethod
    def init_noise_sigma(sigmas: np.ndarray) -> float:
        return float((sigmas.max() ** 2 + 1.0) ** 0.5)

    @staticmethod
    def scale_model_input(sample, sigma):
        return sample / (sigma ** 2 + 1.0) ** 0.5

    @staticmethod
    def step(model_output, sigma, sigma_next, sample):
        """Epsilon prediction, no churn."""
        denoised = sample - sigma * model_output
        derivative = (sample - denoised) / sigma
        return sample + derivative * (sigma_next - sigma)
