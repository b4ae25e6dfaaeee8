"""Story-agent generation in PyTorch; counterpart of
``seed_story_tpu/decode/generate.py``.

Prefill (image features scattered into the token slots, logits at the last
prompt position only) -> decode: the plain loop (greedy, or temperature /
top-p sampling seeded by ``generate(seed=...)``) or prompt-lookup
speculation (``speculate_k``) -> the hidden states of the
``num_img_gen_tokens`` tokens before the LAST ``</img>`` -> the output
resampler. ``generate(cache=...)`` appends to a KV cache that the caller
threads across calls (the sink flows); ``return_cache`` hands it back.

One story per call (B = 1; the lockstep batch is not ported yet). The
prompt runs unpadded and the image axis is not padded to a fixed count: the
JAX package pads both to bound its compiled programs, which changes no
result. ``prompt_bucket`` stays for the capacity rule of ``run_sink``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.tokenizer import BOI_TOKEN_ID, EOI_TOKEN_ID, NUM_IMG_TOKENS
from ..models.llama import KVCache, derive_seed
from .logits_processors import ImageTokenAutomaton


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of descending-probability
    tokens whose cumulative mass reaches ``top_p``; the rest go to -inf."""
    sorted_l = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_l, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    drop = (cum - probs) >= top_p  # cumulative mass BEFORE this token
    thresh = torch.where(drop, float("inf"), sorted_l).amin(dim=-1, keepdim=True)
    return torch.where(logits >= thresh, logits, float("-inf"))


@dataclasses.dataclass
class GenerateConfig:
    max_new_tokens: int = 500
    num_img_gen_tokens: int = NUM_IMG_TOKENS
    eos_token_id: int = 2
    eoi_token_id: int = EOI_TOKEN_ID
    cache_capacity: int = 4096
    prompt_bucket: int = 128  # the JAX package's prompt padding, for capacity rules
    # 0 => greedy; > 0 => temperature + nucleus sampling, seeded by generate(seed=...)
    temperature: float = 0.0
    top_p: float = 1.0
    # force a '<img>' at this decode step unless an image chain is open
    # (untrained weights never open one themselves). None disables.
    force_boi_at: Optional[int] = None
    # > 0: greedy prompt-lookup speculation, K drafted tokens verified in one
    # K + 1 query pass; K + 1 must stay on the small-query cache path (<= 8)
    speculate_k: int = 0
    # hand the KV cache back (the sink flows thread it across calls)
    return_cache: bool = True

    def __post_init__(self):
        if self.speculate_k > 7:
            raise ValueError(
                f"speculate_k={self.speculate_k}: K+1 verify queries must stay <= 8 to ride "
                "the small-query cache path (decode_attention); use speculate_k <= 7.")


class StoryGenerator:
    def __init__(self, agent, cfg: GenerateConfig):
        self.agent = agent
        self.cfg = cfg
        self.device = next(agent.parameters()).device
        self.automaton = ImageTokenAutomaton(
            agent.cfg.llm.vocab_padded, num_img_gen_tokens=cfg.num_img_gen_tokens,
            device=self.device)
        self._forced_next = self.automaton.forced_next.cpu().numpy()

    def _pick(self, prev: torch.Tensor, logits: torch.Tensor, step: int,
              sampler: Optional[Tuple[torch.Generator, int]] = None) -> torch.Tensor:
        """The next token of the plain loop: the automaton, then greedy or
        (with a temperature) a Gumbel-max draw from the tempered, nucleus-
        filtered logits; ``sampler`` is the call's generator and seed, and
        the generator is reseeded from (seed, step) for each draw."""
        cfg = self.cfg
        logits = self.automaton(prev, logits.float())
        if cfg.temperature > 0.0:
            scaled = logits / cfg.temperature
            if cfg.top_p < 1.0:
                scaled = top_p_filter(scaled, cfg.top_p)
            rng, seed = sampler
            rng.manual_seed(derive_seed(seed, step))
            u = torch.rand(scaled.shape, generator=rng, device=scaled.device)
            tok = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
        else:
            tok = torch.argmax(logits, dim=-1)
        if step == cfg.force_boi_at:
            in_chain = self.automaton.forced_next[prev] >= 0
            tok = torch.where(in_chain, tok, BOI_TOKEN_ID)
        return tok

    @torch.inference_mode()
    def generate(self, input_ids, image_embeds, embeds_cmp_mask, ids_cmp_mask,
                 cache: Optional[KVCache] = None, seed: int = 0):
        """input_ids (P,) prompt; image_embeds (N, vit_tokens, vit_dim);
        embeds_cmp_mask (N,) bool; ids_cmp_mask (P,) bool. With ``cache`` the
        prompt is appended to it (and the cache is updated in place).
        Returns generate_ids (numpy), has_img_output, img_gen_feat ((1, 256,
        vit_dim) or None), num_generated and cache (None unless
        ``return_cache``)."""
        cfg, agent, dev = self.cfg, self.agent, self.device
        ids = torch.as_tensor(np.asarray(input_ids, np.int64).reshape(1, -1), device=dev)
        p = ids.shape[1]
        cmp_mask = torch.as_tensor(np.asarray(ids_cmp_mask, bool).reshape(1, -1), device=dev)
        emask = torch.as_tensor(np.asarray(embeds_cmp_mask, bool), device=dev)
        image_embeds = torch.as_tensor(image_embeds, device=dev)
        max_new = cfg.max_new_tokens
        slack = cfg.speculate_k + 1 if cfg.speculate_k else 0
        llm_cfg = agent.cfg.llm
        if cache is None:
            if cfg.return_cache:
                capacity = cfg.cache_capacity
            else:
                if cfg.speculate_k == 0 and p + max_new > cfg.cache_capacity:
                    raise ValueError(f"prompt {p} + max_new_tokens {max_new} exceeds "
                                     f"cache_capacity {cfg.cache_capacity}")
                # speculation writes a K + 1 block past the last committed token
                capacity = -(-(p + max_new + slack) // 128) * 128
            cache = KVCache.create(llm_cfg, 1, capacity, dtype=llm_cfg.dtype, device=dev)
        elif not cfg.return_cache:
            raise ValueError("return_cache=False cannot thread a cache")

        embeds = agent.embed_with_images(ids, image_embeds, cmp_mask, emask)
        out = agent.llm_step(embeds, cache, logits_indices=torch.tensor([p - 1], device=dev))
        hidden = torch.zeros((1, max_new + slack, out["hidden_states"].shape[-1]),
                             dtype=out["hidden_states"].dtype, device=dev)
        sampler = None
        if cfg.temperature > 0.0:
            sampler = (torch.Generator(device=dev), seed)
        first = self._pick(ids[:, p - 1], out["logits"][:, 0], 0, sampler)
        if cfg.speculate_k:
            if cfg.temperature > 0.0:
                raise ValueError("speculative decoding is greedy-only")
            gen_ids = self._spec_loop(cache, int(first), hidden,
                                      np.asarray(input_ids, np.int64).reshape(-1))
        else:
            gen_ids = self._plain_loop(cache, first, hidden, sampler)

        eoi = np.flatnonzero(gen_ids == cfg.eoi_token_id)
        feats = None
        if len(eoi):
            start = max(int(eoi[-1]) - cfg.num_img_gen_tokens, 0)
            feats = agent.resample_output(hidden[:, start:start + cfg.num_img_gen_tokens])
        return {"generate_ids": gen_ids, "has_img_output": feats is not None,
                "img_gen_feat": feats, "num_generated": len(gen_ids),
                "cache": cache if cfg.return_cache else None}

    def _plain_loop(self, cache, first, hidden, sampler):
        """One token a pass; the step that consumes EOS ends the story. Fills
        ``hidden``; returns the generated ids (numpy)."""
        cfg, agent = self.cfg, self.agent
        max_new = cfg.max_new_tokens
        tokens = torch.zeros((1, max_new), dtype=torch.int64, device=self.device)
        tokens[:, 0] = first
        num_generated = 1
        for i in range(1, max_new):
            tok = tokens[:, i - 1]
            if int(tok) == cfg.eos_token_id:
                num_generated = i
                break
            out = agent.llm_step(agent.embed_tokens(tok[:, None]), cache)
            hidden[:, i - 1] = out["hidden_states"][:, 0]
            tokens[:, i] = self._pick(tok, out["logits"][:, 0], i, sampler)
            num_generated = i + 1
        return tokens[0, :num_generated].cpu().numpy()

    def _draft(self, hist: np.ndarray, hlen: int) -> np.ndarray:
        """The K tokens after the most recent earlier occurrence of the
        trailing bigram of ``hist[:hlen]`` (or the K slots after ``hlen``
        when there is none), with the JAX slices' clamping; a bad draft only
        costs acceptance, never output."""
        k = self.cfg.speculate_k
        at = max(0, hlen - 2)
        match = np.flatnonzero((hist[:-1] == hist[at]) & (hist[1:] == hist[at + 1]))
        match = match[match < hlen - 2]
        src = int(match[-1]) + 2 if len(match) else hlen
        src = min(src, len(hist) - k)
        return hist[src:src + k]

    def _spec_loop(self, cache, first: int, hidden, prompt: np.ndarray):
        """Greedy speculation by prompt lookup, the JAX ``_spec_loop`` at
        B = 1: each pass feeds [t_prev, d_0 .. d_{K-1}] through the cache in
        one K + 1 query pass, commits the verified prefix plus one token, and
        rolls the cache back to the committed length. One device-to-host
        copy a pass. Fills ``hidden``; returns the generated ids (numpy)."""
        cfg, agent, dev = self.cfg, self.agent, self.device
        k, max_new, eos = cfg.speculate_k, cfg.max_new_tokens, cfg.eos_token_id
        tokens = np.zeros(max_new + k + 1, np.int64)  # K + 1 slack, as the JAX buffers
        tokens[0] = first
        p0 = len(prompt)
        hist = np.concatenate([prompt.astype(np.int64), np.zeros(max_new + k + 1, np.int64)])
        idx, done = 1, False
        while idx < max_new and not done:
            hist[p0:] = tokens
            drafts = self._draft(hist, p0 + idx)
            block = np.concatenate([tokens[idx - 1:idx], drafts])
            length = cache.length[0]
            block_t = torch.as_tensor(block, device=dev)
            out = agent.llm_step(agent.embed_tokens(block_t[None]), cache)
            picked = self.automaton(block_t, out["logits"][0].float())
            nxt = torch.argmax(picked, dim=-1).cpu().numpy()
            if cfg.force_boi_at is not None:
                force = ((idx + np.arange(k + 1) == cfg.force_boi_at)
                         & (self._forced_next[block] < 0))
                nxt = np.where(force, BOI_TOKEN_ID, nxt)
            accept = int(np.cumprod(nxt[:k] == drafts).sum())
            is_eos = np.flatnonzero(nxt == eos)
            first_eos = int(is_eos[0]) if len(is_eos) else k + 1
            ncommit = min(accept + 1, first_eos + 1, max_new - idx)
            # EOS ends the story when it is consumed: a pass that feeds it
            # commits nothing
            prev_is_eos = int(block[0]) == eos
            if prev_is_eos:
                ncommit = 0
            done = prev_is_eos or first_eos + 1 <= ncommit or idx + ncommit >= max_new
            tokens[idx:idx + k + 1] = nxt
            hidden[0, idx - 1:idx + k] = out["hidden_states"][0]
            # keep t_prev and the consumed drafts; the rest is overwritten later
            cache.length = [length + ncommit]
            idx += ncommit
        return tokens[:idx]
