"""Stage-3 de-tokenizer adaptation loss: frozen ViT -> frozen agent forward
(its ``recon_image_embeds``) -> frozen VAE encode of the target frames ->
DDPM noise -> SDXLAdapter eps-MSE; only the adapter (resampler and the UNet's
``to_k`` / ``to_v``) trains. Counterpart of ``seed_story_tpu/train/stage3.py``.

Over a mesh each rank's batch holds its rows of the global batch (the data
pipeline's shard: ``parallel/collectives.py::data_shard``), and the step's
draws are those of the global batch: every rank draws the noise, the
timesteps and the VAE's posterior sample at the global latent shape and
keeps its rows, as the JAX step draws over its sharded batch. So a sample
gets the draw it gets in the one-process step on the global batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.sdxl.schedulers import DDPMScheduler
from ..parallel.collectives import bound_group

# draw(seed, latent_shape, device) -> (noise f32, timesteps (B,) int32,
# the VAE's posterior draw f32), the noise and the draw of latent_shape (the
# global batch's)
Draw = Callable[[int, Tuple[int, ...], torch.device],
                Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def select_gen_embeds(recon_image_embeds, embeds_gen_mask, batch_size: int):
    """(B * max_images, nq, D) features and the per-image gen mask -> (B, nq,
    D): each sample's generation target (the first image of a sample with
    none)."""
    max_images = embeds_gen_mask.shape[0] // batch_size
    mask = embeds_gen_mask.reshape(batch_size, max_images).to(torch.int32)
    offsets = torch.arange(batch_size, device=mask.device) * max_images
    return recon_image_embeds[torch.argmax(mask, dim=1) + offsets]


def seeded_draw(scheduler: DDPMScheduler, seed: int, latent_shape, device):
    """The default draws of a step: the noise, the timesteps and the VAE's
    draw, in that order, from one generator seeded with ``seed`` on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(latent_shape, generator=gen, device=device)
    timesteps = scheduler.sample_timesteps(latent_shape[0], gen)
    return noise, timesteps, torch.randn(latent_shape, generator=gen, device=device)


def make_stage3_loss_fn(adapter: nn.Module, agent: nn.Module, vae: nn.Module,
                        vit: Optional[nn.Module] = None,
                        scheduler: Optional[DDPMScheduler] = None,
                        draw: Optional[Draw] = None):
    """loss_fn(batch, seed) -> (loss, metrics) for
    :class:`~seed_story_torch.train.trainer.Trainer`.

    The ViT (when given; else the batch carries ``image_embeds``), the agent
    and the VAE are frozen and run under ``torch.no_grad()``. ``draw`` gives
    the step's random draws from its seed; the default is
    :func:`seeded_draw` on the batch's device. Every microbatch of a step gets the
    step's seed, so the same draws, as the JAX step reuses its rng across
    its accumulation scan. Inside a step bound to a data-parallel group of n
    ranks (``parallel.collectives.data_parallel``), ``draw`` is asked for the
    global batch's n times the local rows, and rank r keeps rows
    [r b, (r + 1) b)."""
    sch = scheduler or DDPMScheduler()

    draw_fn = draw or (lambda seed, shape, device: seeded_draw(sch, seed, shape, device))

    def global_draw(seed: int, latent_shape, device):
        """This rank's rows of the global batch's draws."""
        group = bound_group("data")
        if group is None or dist.get_world_size(group) == 1:
            return draw_fn(seed, latent_shape, device)
        b, n = latent_shape[0], dist.get_world_size(group)
        draws = draw_fn(seed, (b * n, *latent_shape[1:]), device)
        first = dist.get_rank(group) * b
        return tuple(t[first:first + b] for t in draws)

    def loss_fn(batch: Dict[str, torch.Tensor], seed: int):
        b = batch["input_ids"].shape[0]
        with torch.no_grad():
            image_embeds = vit(batch["images"]) if vit is not None else batch["image_embeds"]
            agent_out = agent(input_ids=batch["input_ids"],
                              attention_mask=batch["attention_mask"], labels=batch["labels"],
                              image_embeds=image_embeds,
                              embeds_gen_mask=batch["embeds_gen_mask"],
                              embeds_cmp_mask=batch["embeds_cmp_mask"],
                              ids_gen_mask=batch["ids_gen_mask"],
                              ids_cmp_mask=batch["ids_cmp_mask"])
            recon = select_gen_embeds(agent_out["recon_image_embeds"],
                                      batch["embeds_gen_mask"], b)
            pixels = batch["sd_images"].permute(0, 2, 3, 1)  # NCHW -> NHWC
            noise, timesteps, eps = global_draw(seed, vae.latent_shape(pixels.shape),
                                                pixels.device)
            latents = vae.encode(pixels, eps=eps)
            noisy = sch.add_noise(latents, noise, timesteps)
        out = adapter(noisy.to(adapter.cfg.unet.dtype), timesteps, recon,
                      batch["time_ids"].float(), noise)
        return out["total_loss"], {"mse_loss": out["total_loss"].detach()}

    return loss_fn
