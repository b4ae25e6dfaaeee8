"""Stage-2 SFT loss: frozen ViT -> agent CE + cosine losses; counterpart of
``seed_story_tpu/train/stage2.py``."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn


def make_stage2_loss_fn(agent: nn.Module, vit: Optional[nn.Module] = None):
    """loss_fn(batch, dropout_seed) -> (loss, metrics) for
    :class:`~seed_story_torch.train.trainer.Trainer`.

    With ``vit``, ``batch["images"]`` (N, 3, H, W) goes through the frozen
    ViT under ``torch.no_grad()``; its features are both the input
    resampler's input and the cosine target. Otherwise the batch carries
    ``image_embeds``."""

    def loss_fn(batch: Dict[str, torch.Tensor], dropout_seed: int):
        if vit is not None:
            with torch.no_grad():
                image_embeds = vit(batch["images"])
        else:
            image_embeds = batch["image_embeds"]
        out = agent(input_ids=batch["input_ids"], attention_mask=batch["attention_mask"],
                    labels=batch["labels"], image_embeds=image_embeds,
                    embeds_gen_mask=batch["embeds_gen_mask"],
                    embeds_cmp_mask=batch["embeds_cmp_mask"],
                    ids_gen_mask=batch["ids_gen_mask"], ids_cmp_mask=batch["ids_cmp_mask"],
                    dropout_seed=dropout_seed)
        metrics = {"lm_loss": out["lm_loss"].detach(), "rec_loss": out["rec_loss"].detach()}
        return out["total_loss"], metrics

    return loss_fn
