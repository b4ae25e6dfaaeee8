"""The forced image-token automaton as table lookups on tensors;
counterpart of ``seed_story_tpu/decode/logits_processors.py``.

After any token of the chain ``<img> <img_00000> ... <img_00063>`` the next
token is forced to its successor (score max + 10); elsewhere the 65 ids
``<img_00000> .. </img>`` get score 0.0."""

from __future__ import annotations

import numpy as np
import torch

from ..data.tokenizer import (
    BOI_TOKEN_ID,
    EOI_TOKEN_ID,
    FIRST_IMG_TOKEN_ID,
    NUM_IMG_TOKENS,
)


class ImageTokenAutomaton:
    def __init__(self, vocab_size: int, num_img_gen_tokens: int = NUM_IMG_TOKENS,
                 boi_token_id: int = BOI_TOKEN_ID, eoi_token_id: int = EOI_TOKEN_ID,
                 first_img_token_id: int = FIRST_IMG_TOKEN_ID, device=None):
        chain = ([boi_token_id] + [first_img_token_id + i for i in range(num_img_gen_tokens)]
                 + [eoi_token_id])
        forced = np.full((vocab_size,), -1, np.int64)
        for cur, nxt in zip(chain[:-1], chain[1:]):
            forced[cur] = nxt
        suppress = np.zeros((vocab_size,), bool)
        suppress[chain[1:]] = True  # image tokens and </img>, not <img>
        self.forced_next = torch.from_numpy(forced).to(device)
        self.suppress_mask = torch.from_numpy(suppress).to(device)

    def __call__(self, prev_token: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
        """prev_token: (B,) int; scores: (B, V) raw logits."""
        forced = self.forced_next[prev_token]
        in_chain = (forced >= 0)[:, None]
        scores = torch.where(in_chain, scores, scores.masked_fill(self.suppress_mask, 0.0))
        big = scores.max(dim=-1, keepdim=True).values + 10.0
        onehot = torch.arange(scores.shape[-1], device=scores.device)[None] == forced.clamp(min=0)[:, None]
        return torch.where(in_chain & onehot, big, scores)
