"""Story-agent generation in PyTorch; counterpart of
``seed_story_tpu/decode/generate.py``.

Prefill (image features scattered into the token slots, logits at the last
prompt position only) -> decode: the plain loop (greedy, or temperature /
top-p sampling seeded by ``generate(seed=...)``) or prompt-lookup
speculation (``speculate_k``) -> the hidden states of the
``num_img_gen_tokens`` tokens before the LAST ``</img>`` -> the output
resampler. ``generate(cache=...)`` appends to a KV cache that the caller
threads across calls (the sink flows); ``return_cache`` hands it back.

``generate`` runs one story; ``generate_batch`` runs B stories in lockstep
(the serving path): their prompts right-padded to the longest one and
prefilled in one pass with per-row ``seq_lengths``, then one decode loop in
which each row has its own ``done``, token count and, under speculation,
its own position, accept count and cache length (a finished row keeps
riding the passes with nothing committed). The prompt is not padded to a
bucket and the image axis not to a fixed count per story: the JAX package
pads both to bound its compiled programs, which changes no result (the
stories' images, flattened in row order, scatter into the same slots).
``prompt_bucket`` stays for the capacity rules (``run_sink``'s guard, the
fresh cache of ``generate_batch``).
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
    """Generation for one agent. ``mesh``: a ``parallel.mesh.DeviceGrid`` of
    shape (1, tp) (``make_mesh(1, tp, devices)``); with tp > 1 the agent's
    LLaMA is split in place over those devices (:func:`~seed_story_torch.
    decode.tensor_parallel.shard_llama_`; the JAX
    ``StoryGenerator(mesh=..., sharding_preset="fsdp_tp")``) and its KV
    caches are split by KV heads."""

    def __init__(self, agent, cfg: GenerateConfig, mesh=None):
        self.agent = agent
        self.cfg = cfg
        self.tp_devices = None
        if mesh is not None and mesh.shape["model"] > 1:
            from .tensor_parallel import shard_llama_

            if mesh.shape["data"] != 1:
                raise ValueError(f"tensor-parallel decode takes a 1 x tp mesh, got {mesh.shape}")
            self.tp_devices = mesh.devices[0]
            shard_llama_(agent.llm, self.tp_devices)
        self.device = next(agent.parameters()).device
        self.automaton = ImageTokenAutomaton(
            agent.cfg.llm.vocab_padded, num_img_gen_tokens=cfg.num_img_gen_tokens,
            device=self.device)
        self._forced_next = self.automaton.forced_next.cpu().numpy()

    def _pick(self, prev: torch.Tensor, logits: torch.Tensor, step: int,
              sampler: Optional[Tuple[torch.Generator, int]] = None) -> torch.Tensor:
        """The next token of each row of the plain loop, (B,) from (B,) and
        (B, V): the automaton, then greedy or (with a temperature) a
        Gumbel-max draw from the tempered, nucleus-filtered logits;
        ``sampler`` is the call's generator and seed, and the generator is
        reseeded from (seed, step) for each draw over the whole (B, V)."""
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
        cfg = self.cfg
        prompt = np.asarray(input_ids, np.int64).reshape(-1)
        p = len(prompt)
        if cache is None:
            if cfg.return_cache:
                capacity = cfg.cache_capacity
            else:
                if cfg.speculate_k == 0 and p + cfg.max_new_tokens > cfg.cache_capacity:
                    raise ValueError(f"prompt {p} + max_new_tokens {cfg.max_new_tokens} "
                                     f"exceeds cache_capacity {cfg.cache_capacity}")
                # speculation writes a K + 1 block past the last committed token
                capacity = -(-(p + cfg.max_new_tokens + self._slack()) // 128) * 128
            cache = self._new_cache(1, capacity)
        elif not cfg.return_cache:
            raise ValueError("return_cache=False cannot thread a cache")
        out = self._run([prompt], [np.asarray(ids_cmp_mask, bool).reshape(-1)],
                        torch.as_tensor(image_embeds, device=self.device),
                        np.asarray(embeds_cmp_mask, bool), cache, seed)[0]
        out["cache"] = cache if cfg.return_cache else None
        return out

    @torch.inference_mode()
    def generate_batch(self, stories, seed: int = 0):
        """B independent stories in lockstep: one prefill and one decode loop
        for all of them, each row stopping on its own. ``stories``: dicts
        with ``input_ids`` (P_i,), ``image_embeds`` (N_i, vit_tokens,
        vit_dim), ``embeds_cmp_mask`` (N_i,) and ``ids_cmp_mask`` (P_i,).
        Sampling draws once a step over the (B, V) logits. Returns one
        result dict per story, as ``generate`` without the cache: the
        batched mode serves the story flow, which re-prefills every
        segment, so the generator must be built with ``return_cache=False``.
        The fresh cache holds the longest prompt rounded up to
        ``prompt_bucket``, ``max_new_tokens`` and the K + 1 slack of
        speculation, rounded up to 128 (without speculation at most
        ``cache_capacity``)."""
        cfg = self.cfg
        if cfg.return_cache:
            raise ValueError("generate_batch serves the re-prefill story flow; build the "
                             "StoryGenerator with return_cache=False")
        prompts = [np.asarray(s["input_ids"], np.int64).reshape(-1) for s in stories]
        p_max = max(len(ids) for ids in prompts)
        bucket = -(-p_max // cfg.prompt_bucket) * cfg.prompt_bucket
        capacity = -(-(bucket + cfg.max_new_tokens + self._slack()) // 128) * 128
        if cfg.speculate_k == 0:
            capacity = min(cfg.cache_capacity, capacity)
            if p_max + cfg.max_new_tokens > capacity:
                raise ValueError(f"prompt {p_max} + max_new_tokens {cfg.max_new_tokens} "
                                 f"exceeds cache_capacity {cfg.cache_capacity}")
        image_embeds = torch.cat([torch.as_tensor(s["image_embeds"], device=self.device)
                                  for s in stories])
        embeds_cmp_mask = np.concatenate([np.asarray(s["embeds_cmp_mask"], bool).reshape(-1)
                                          for s in stories])
        cmp_masks = [np.asarray(s["ids_cmp_mask"], bool).reshape(-1) for s in stories]
        return self._run(prompts, cmp_masks, image_embeds, embeds_cmp_mask,
                         self._new_cache(len(stories), capacity), seed)

    def _slack(self) -> int:
        return self.cfg.speculate_k + 1 if self.cfg.speculate_k else 0

    def _new_cache(self, batch: int, capacity: int) -> KVCache:
        llm_cfg = self.agent.cfg.llm
        if self.tp_devices is not None:
            from .tensor_parallel import ShardedKVCache

            return ShardedKVCache.create(llm_cfg, self.tp_devices, batch, capacity)
        return KVCache.create(llm_cfg, batch, capacity, dtype=llm_cfg.dtype, device=self.device)

    def _run(self, prompts, cmp_masks, image_embeds, embeds_cmp_mask, cache: KVCache,
             seed: int):
        """Prefill the right-padded prompts (B, P_max) with per-row lengths,
        decode, and regress each row's image features from the hidden states
        of the ``num_img_gen_tokens`` tokens before its LAST ``</img>``."""
        cfg, agent, dev = self.cfg, self.agent, self.device
        b, lens = len(prompts), [len(ids) for ids in prompts]
        p_max = max(lens)
        ids_np = np.zeros((b, p_max), np.int64)
        cmp_np = np.zeros((b, p_max), bool)
        for r, (ids, cmp_) in enumerate(zip(prompts, cmp_masks)):
            ids_np[r, :lens[r]], cmp_np[r, :lens[r]] = ids, cmp_[:lens[r]]
        ids = torch.as_tensor(ids_np, device=dev)
        last = torch.as_tensor(np.asarray(lens) - 1, device=dev)
        embeds = agent.embed_with_images(ids, image_embeds, torch.as_tensor(cmp_np, device=dev),
                                         torch.as_tensor(embeds_cmp_mask, device=dev))
        # unpadded prompts keep the cached forward's default lengths
        out = agent.llm_step(embeds, cache, seq_lengths=None if min(lens) == p_max else lens,
                             logits_indices=last)
        max_new = cfg.max_new_tokens
        hidden = torch.zeros((b, max_new + self._slack(), out["hidden_states"].shape[-1]),
                             dtype=out["hidden_states"].dtype, device=dev)
        sampler = None
        if cfg.temperature > 0.0:
            sampler = (torch.Generator(device=dev), seed)
        rows = torch.arange(b, device=dev)
        first = self._pick(ids[rows, last], out["logits"][:, 0], 0, sampler)
        if cfg.speculate_k:
            if cfg.temperature > 0.0:
                raise ValueError("speculative decoding is greedy-only")
            gen_ids = self._spec_loop(cache, first.cpu().numpy(), hidden, prompts)
        else:
            gen_ids = self._plain_loop(cache, first, hidden, sampler)

        blocks, starts = [], []
        for r, row_ids in enumerate(gen_ids):
            eoi = np.flatnonzero(row_ids == cfg.eoi_token_id)
            if len(eoi):
                start = max(int(eoi[-1]) - cfg.num_img_gen_tokens, 0)
                blocks.append(hidden[r, start:start + cfg.num_img_gen_tokens])
                starts.append(r)
        feats = agent.resample_output(torch.stack(blocks)) if blocks else None
        results = []
        for r, row_ids in enumerate(gen_ids):
            feat = feats[starts.index(r)][None] if r in starts else None
            results.append({"generate_ids": row_ids, "has_img_output": feat is not None,
                            "img_gen_feat": feat, "num_generated": len(row_ids)})
        return results

    def _plain_loop(self, cache, first, hidden, sampler):
        """One token a pass for every row; the step that consumes a row's EOS
        ends that row (a finished row rides on, its count frozen), and the
        loop ends when every row has ended. One host sync a token. Fills
        ``hidden``; returns each row's generated ids (numpy)."""
        cfg, agent = self.cfg, self.agent
        b, max_new = len(first), cfg.max_new_tokens
        tokens = torch.zeros((b, max_new), dtype=torch.int64, device=self.device)
        tokens[:, 0] = first
        done = np.zeros(b, bool)
        num_generated = np.ones(b, np.int64)
        for i in range(1, max_new):
            tok = tokens[:, i - 1]
            newly_done = (tok.cpu().numpy() == cfg.eos_token_id) & ~done
            num_generated[newly_done] = i
            done |= newly_done
            if done.all():
                break
            out = agent.llm_step(agent.embed_tokens(tok[:, None]), cache)
            hidden[:, i - 1] = out["hidden_states"][:, 0]
            nxt = self._pick(tok, out["logits"][:, 0], i, sampler)
            if done.any():  # a finished row keeps its slot
                nxt = torch.where(torch.as_tensor(done, device=self.device), tokens[:, i], nxt)
            tokens[:, i] = nxt
            num_generated[~done] = i + 1
        tokens = tokens.cpu().numpy()
        return [tokens[r, :num_generated[r]] for r in range(b)]

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

    def _spec_loop(self, cache, first: np.ndarray, hidden, prompts):
        """Greedy speculation by prompt lookup, the JAX ``_spec_loop``: each
        pass feeds every row's [t_prev, d_0 .. d_{K-1}] through the cache in
        one (B, K + 1) query pass, and each row commits its verified prefix
        plus one token and rolls its cache length back to what it committed.
        A finished row keeps riding the pass with nothing committed (its
        writes land past its length). One device-to-host copy a pass; the
        drafts are drawn on the host, one per row. Fills ``hidden``; returns
        each row's generated ids (numpy)."""
        cfg, agent, dev = self.cfg, self.agent, self.device
        k, max_new, eos = cfg.speculate_k, cfg.max_new_tokens, cfg.eos_token_id
        b = len(prompts)
        tokens = np.zeros((b, max_new + k + 1), np.int64)  # K + 1 slack, as the JAX buffers
        tokens[:, 0] = first
        idx, done = np.ones(b, np.int64), np.zeros(b, bool)
        steps = np.arange(k + 1)
        while ((idx < max_new) & ~done).any():
            drafts = np.stack([self._draft(np.concatenate([prompts[r], tokens[r]]),
                                           len(prompts[r]) + idx[r]) for r in range(b)])
            block = np.concatenate([tokens[np.arange(b), idx - 1][:, None], drafts], axis=1)
            length = np.asarray(cache.length)
            block_t = torch.as_tensor(block, device=dev)
            out = agent.llm_step(agent.embed_tokens(block_t), cache)
            picked = self.automaton(block_t.reshape(-1),
                                    out["logits"].reshape(b * (k + 1), -1).float())
            nxt = torch.argmax(picked, dim=-1).reshape(b, k + 1).cpu().numpy()
            if cfg.force_boi_at is not None:
                force = ((idx[:, None] + steps == cfg.force_boi_at)
                         & (self._forced_next[block] < 0))
                nxt = np.where(force, BOI_TOKEN_ID, nxt)
            accept = np.cumprod(nxt[:, :k] == drafts, axis=1).sum(axis=1)
            first_eos = np.where(nxt == eos, steps, k + 1).min(axis=1)
            ncommit = np.minimum(np.minimum(accept + 1, first_eos + 1), max_new - idx)
            # EOS ends a story when it is consumed: a pass that feeds it
            # commits nothing; a finished row is frozen the same way
            prev_is_eos = block[:, 0] == eos
            ncommit = np.where(prev_is_eos | done, 0, ncommit)
            done |= prev_is_eos | (first_eos + 1 <= ncommit) | (idx + ncommit >= max_new)
            for r in range(b):
                tokens[r, idx[r]:idx[r] + k + 1] = nxt[r]
                hidden[r, idx[r] - 1:idx[r] + k] = out["hidden_states"][r]
            # keep t_prev and the consumed drafts; the rest is overwritten later
            cache.length = (length + ncommit).tolist()
            idx = idx + ncommit
        return [tokens[r, :idx[r]] for r in range(b)]
