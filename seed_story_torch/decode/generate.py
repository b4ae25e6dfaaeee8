"""Greedy story-agent generation in PyTorch; counterpart of the plain path
of ``seed_story_tpu/decode/generate.py``.

Prefill (image features scattered into the token slots, logits at the last
prompt position only) -> greedy decode with the image-token automaton and
``force_boi_at`` -> the hidden states of the ``num_img_gen_tokens`` tokens
before the LAST ``</img>`` -> the output resampler. One story per call; the
prompt runs unpadded (the JAX package pads it to a bucket for its compiled
programs, which changes no result).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..data.tokenizer import BOI_TOKEN_ID, EOI_TOKEN_ID, NUM_IMG_TOKENS
from ..models.llama import KVCache
from .logits_processors import ImageTokenAutomaton


@dataclasses.dataclass
class GenerateConfig:
    max_new_tokens: int = 500
    num_img_gen_tokens: int = NUM_IMG_TOKENS
    eos_token_id: int = 2
    eoi_token_id: int = EOI_TOKEN_ID
    cache_capacity: int = 4096
    # force a '<img>' at this decode step unless an image chain is open
    # (untrained weights never open one themselves). None disables.
    force_boi_at: Optional[int] = None


class StoryGenerator:
    def __init__(self, agent, cfg: GenerateConfig):
        self.agent = agent
        self.cfg = cfg
        self.device = next(agent.parameters()).device
        self.automaton = ImageTokenAutomaton(
            agent.cfg.llm.vocab_padded, num_img_gen_tokens=cfg.num_img_gen_tokens,
            device=self.device)

    def _pick(self, prev: torch.Tensor, logits: torch.Tensor, step: int) -> torch.Tensor:
        tok = torch.argmax(self.automaton(prev, logits.float()), dim=-1)
        if step == self.cfg.force_boi_at:
            in_chain = self.automaton.forced_next[prev] >= 0
            tok = torch.where(in_chain, tok, BOI_TOKEN_ID)
        return tok

    @torch.inference_mode()
    def generate(self, input_ids, image_embeds, embeds_cmp_mask, ids_cmp_mask):
        """input_ids (P,) prompt; image_embeds (N, vit_tokens, vit_dim);
        embeds_cmp_mask (N,) bool; ids_cmp_mask (P,) bool. Returns
        generate_ids (numpy), has_img_output, img_gen_feat ((1, 256, vit_dim)
        or None) and num_generated."""
        cfg, agent, dev = self.cfg, self.agent, self.device
        ids = torch.as_tensor(np.asarray(input_ids, np.int64).reshape(1, -1), device=dev)
        p = ids.shape[1]
        cmp_mask = torch.as_tensor(np.asarray(ids_cmp_mask, bool).reshape(1, -1), device=dev)
        emask = torch.as_tensor(np.asarray(embeds_cmp_mask, bool), device=dev)
        image_embeds = torch.as_tensor(image_embeds, device=dev)
        max_new = cfg.max_new_tokens
        capacity = -(-(p + max_new) // 128) * 128
        if p + max_new > cfg.cache_capacity:
            raise ValueError(f"prompt {p} + max_new_tokens {max_new} exceeds "
                             f"cache_capacity {cfg.cache_capacity}")
        llm_cfg = agent.cfg.llm
        cache = KVCache.create(llm_cfg, 1, capacity, dtype=llm_cfg.dtype, device=dev)

        embeds = agent.embed_with_images(ids, image_embeds, cmp_mask, emask)
        out = agent.llm_step(embeds, cache, logits_indices=torch.tensor([p - 1], device=dev))
        tokens = torch.zeros((1, max_new), dtype=torch.int64, device=dev)
        hidden = torch.zeros((1, max_new, out["hidden_states"].shape[-1]),
                             dtype=out["hidden_states"].dtype, device=dev)
        tokens[:, 0] = self._pick(ids[:, p - 1], out["logits"][:, 0], 0)
        num_generated = 1
        for i in range(1, max_new):
            tok = tokens[:, i - 1]
            if int(tok) == cfg.eos_token_id:  # the step that consumes eos ends the row
                num_generated = i
                break
            out = agent.llm_step(agent.embed_tokens(tok[:, None]), cache)
            hidden[:, i - 1] = out["hidden_states"][:, 0]
            tokens[:, i] = self._pick(tok, out["logits"][:, 0], i)
            num_generated = i + 1

        gen_ids = tokens[0, :num_generated].cpu().numpy()
        eoi = np.flatnonzero(gen_ids == cfg.eoi_token_id)
        feats = None
        if len(eoi):
            start = max(int(eoi[-1]) - cfg.num_img_gen_tokens, 0)
            feats = agent.resample_output(hidden[:, start:start + cfg.num_img_gen_tokens])
        return {"generate_ids": gen_ids, "has_img_output": feats is not None,
                "img_gen_feat": feats, "num_generated": num_generated}
