"""Story generation pipeline (the gen_george flow) in PyTorch; counterpart
of ``StoryGenerationPipeline.run`` and ``run_sink`` in
``seed_story_tpu/pipelines/story_generation.py``.

``run``: seed with (image, caption); repeatedly: generate text and a forced
image block -> de-tokenize the regressed image features -> feed the
GENERATED features back as context -> while more than ``window_size``
images, strip the oldest "...</img>[INST]" span from the prompt and drop its
features; every segment re-prefills the window's prompt.

``run_sink``: the same story with the KV cache threaded across segments:
each segment prefills only the new image's comprehension block, and old
segments leave through the attention-sink eviction policy
(``decode/sink_cache.py``).

``run_batch``: B stories of the ``run`` flow in lockstep, one
``generate_batch`` a round (the serving path).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch

from ..data.tokenizer import BOI_TOKEN, EOI_TOKEN, image_comprehension_string
from ..decode.generate import StoryGenerator
from ..decode.sink_cache import SinkKVCacheManager

TAG_RE = re.compile(r"\s*<[^>]*>\s*")


@dataclasses.dataclass
class StoryPipelineConfig:
    story_len: int = 25
    window_size: int = 8
    num_img_in_tokens: int = 64
    instruction_prompt: str = "{instruction}"
    # run_sink only: cap on retained sink tokens (None = the reference's
    # policy, which grows ~24-28 tokens per evicted image forever)
    sink_max_tokens: Optional[int] = None


@dataclasses.dataclass
class StorySegment:
    index: int
    text: str
    image: Optional[Any]  # de-tokenizer output (uint8 HWC array) or None
    image_features: Optional[torch.Tensor] = None  # (1, 256, vit_dim)
    context_tokens: int = 0


class StoryGenerationPipeline:
    def __init__(self, tokenizer, generator: StoryGenerator,
                 visual_encode: Callable[[np.ndarray], torch.Tensor],
                 detokenize: Optional[Callable[[torch.Tensor], Any]] = None,
                 cfg: StoryPipelineConfig = StoryPipelineConfig()):
        self.tokenizer = tokenizer
        self.generator = generator
        self.visual_encode = visual_encode
        self.detokenize = detokenize
        self.cfg = cfg
        self._boi_id = tokenizer.encode(BOI_TOKEN, add_special_tokens=False)[0]
        self._eoi_id = tokenizer.encode(EOI_TOKEN, add_special_tokens=False)[0]

    def _ids_and_masks(self, prompt: str, n_images: int):
        ids = np.asarray([self.tokenizer.bos_token_id]
                         + self.tokenizer.encode(prompt, add_special_tokens=False), np.int64)
        boi = np.flatnonzero(ids == self._boi_id)
        eoi = np.flatnonzero(ids == self._eoi_id)
        ids_cmp = np.zeros(len(ids), bool)
        for i in range(n_images):
            ids_cmp[boi[i] + 1: eoi[i]] = True
        return ids, ids_cmp

    def _clean(self, token_ids) -> str:
        return TAG_RE.sub(" ", self.tokenizer.decode(token_ids, skip_special_tokens=False)).strip()

    def run(self, image_pixels: np.ndarray, caption: str) -> Iterator[StorySegment]:
        """image_pixels: (1, 3, H, W) CLIP-transformed start frame."""
        cfg = self.cfg
        image_tokens = image_comprehension_string(cfg.num_img_in_tokens)
        prompt = cfg.instruction_prompt.format_map({"instruction": caption + image_tokens})
        image_embeds = self.visual_encode(image_pixels)

        ids, ids_cmp = self._ids_and_masks(prompt, 1)
        out = self.generator.generate(ids, image_embeds, np.ones((1,), bool), ids_cmp)
        text = self._clean(out["generate_ids"])
        if not out["has_img_output"]:
            yield StorySegment(0, text, None, None, len(ids))
            return

        text_id = 1
        while out["has_img_output"] and image_embeds.shape[0] < cfg.story_len:
            feats = out["img_gen_feat"]
            image = self.detokenize(feats) if self.detokenize is not None else None
            yield StorySegment(text_id, text, image, feats, len(ids))

            image_embeds = torch.cat([image_embeds, feats.to(image_embeds.dtype)], dim=0)
            if text_id >= cfg.story_len - 1:
                return
            prompt = prompt + text + image_tokens
            text_id += 1

            while image_embeds.shape[0] > cfg.window_size:  # sliding window
                eoi_idx = prompt.index(EOI_TOKEN)
                prompt = prompt[eoi_idx + len(EOI_TOKEN) + len("[INST]"):]
                image_embeds = image_embeds[1:]

            n_img = int(image_embeds.shape[0])
            ids, ids_cmp = self._ids_and_masks(prompt, n_img)
            out = self.generator.generate(ids, image_embeds, np.ones((n_img,), bool), ids_cmp)
            text = self._clean(out["generate_ids"])

        if not out["has_img_output"]:
            yield StorySegment(text_id, text, None, None, len(ids))

    def run_sink(self, image_pixels: np.ndarray, caption: str) -> Iterator[StorySegment]:
        """Long-story generation with the multimodal attention-sink KV cache
        threaded ACROSS segments (the JAX ``run_sink``). Per segment only the
        just-generated image's comprehension block is prefilled; the
        generated text tokens' KV is kept from decode time; the generated
        image block's KV is dropped (it was written with generation-query
        embeddings, and the story feeds the image back through the
        comprehension block). Old segments leave through the sink eviction
        policy. Context differs from ``run`` in two documented ways: it
        follows the sink policy, not the verbatim window prompt, and the
        generated text stays as raw decoded tokens. A guard refuses a
        segment that could overflow the cache, with the JAX package's rule
        (the prompt padded to ``prompt_bucket``, K + 1 slack for
        speculation), so that both packages refuse the same story. Needs a
        generator built with ``return_cache=True``. ``self.sink`` is the
        run's ``SinkKVCacheManager``."""
        cfg = self.cfg
        gen = self.generator
        if not gen.cfg.return_cache:
            raise ValueError("run_sink threads the KV cache across segments; build the "
                             "StoryGenerator with return_cache=True")
        image_tokens = image_comprehension_string(cfg.num_img_in_tokens)
        suffix_ids = np.asarray(self.tokenizer.encode(image_tokens, add_special_tokens=False),
                                np.int64)
        suffix_cmp = np.zeros(len(suffix_ids), bool)
        sb = int(np.flatnonzero(suffix_ids == self._boi_id)[0])
        se = int(np.flatnonzero(suffix_ids == self._eoi_id)[0])
        suffix_cmp[sb + 1:se] = True

        prompt = cfg.instruction_prompt.format_map({"instruction": caption + image_tokens})
        live_ids, ids_cmp = self._ids_and_masks(prompt, 1)
        sink = self.sink = SinkKVCacheManager(capacity=gen.cfg.cache_capacity,
                                              max_sink=cfg.sink_max_tokens)
        bucket = gen.cfg.prompt_bucket
        slack = gen.cfg.speculate_k + 1 if gen.cfg.speculate_k > 0 else 0

        def guard_capacity(committed: int, prefill_len: int):
            padded = -(-prefill_len // bucket) * bucket
            need = committed + padded + gen.cfg.max_new_tokens + slack
            if need > gen.cfg.cache_capacity:
                raise ValueError(
                    f"run_sink: segment needs {need} cache slots ({committed} committed "
                    f"sink+live, {padded} padded prefill, {gen.cfg.max_new_tokens}+{slack} "
                    f"decode) but cache_capacity={gen.cfg.cache_capacity}. Size the capacity "
                    ">= prompt + window live tokens + max_new + ~28 x (story_len - "
                    "window_size), or set StoryPipelineConfig.sink_max_tokens.")

        guard_capacity(0, len(live_ids))
        out = gen.generate(live_ids, self.visual_encode(image_pixels), np.ones((1,), bool),
                           ids_cmp)
        n_images, text_id = 1, 1
        while True:
            gen_ids = np.asarray(out["generate_ids"], np.int64)
            text = self._clean(gen_ids)
            if not out["has_img_output"]:
                yield StorySegment(0 if text_id == 1 else text_id, text, None, None,
                                   sink.sink_len + len(live_ids))
                return
            feats = out["img_gen_feat"]
            image = self.detokenize(feats) if self.detokenize is not None else None
            yield StorySegment(text_id, text, image, feats,
                               sink.sink_len + len(live_ids) + len(gen_ids))
            if text_id >= cfg.story_len - 1:
                return
            text_id += 1

            # keep the generated TEXT tokens' KV, drop the image block's
            boi_pos = np.flatnonzero(gen_ids == self._boi_id)
            n_text = int(boi_pos[0]) if len(boi_pos) else len(gen_ids)
            live_ids = np.concatenate([live_ids, gen_ids[:n_text]])
            cache = sink.truncate(out["cache"], sink.sink_len + len(live_ids))

            n_images += 1  # the new image below
            while n_images > cfg.window_size:
                boi = int(np.flatnonzero(live_ids == self._boi_id)[0])
                eoi = int(np.flatnonzero(live_ids == self._eoi_id)[0])
                cache, dropped = sink.evict_image_span(cache, boi, eoi, live_len=len(live_ids))
                live_ids = live_ids[dropped:]
                n_images -= 1

            # prefill ONLY the comprehension block of the new image
            guard_capacity(sink.sink_len + len(live_ids), len(suffix_ids))
            out = gen.generate(suffix_ids, feats, np.ones((1,), bool), suffix_cmp, cache=cache)
            live_ids = np.concatenate([live_ids, suffix_ids])

    def run_batch(self, seeds) -> Iterator[List[Optional[StorySegment]]]:
        """B stories of the ``run`` flow in lockstep: each round runs one
        ``StoryGenerator.generate_batch`` for every story (the generator must
        be built with ``return_cache=False``). ``seeds``: (image_pixels,
        caption) pairs. Yields one list a round with a segment per story, or
        None for a story that has ended; a story that ends without an image
        yields its closing text once and then stays dormant, riding the batch
        until every story has ended. Each story keeps its own window."""
        cfg = self.cfg
        image_tokens = image_comprehension_string(cfg.num_img_in_tokens)
        states = [{"prompt": cfg.instruction_prompt.format_map(
                       {"instruction": caption + image_tokens}),
                   "embeds": self.visual_encode(pixels), "alive": True, "text_id": 1}
                  for pixels, caption in seeds]

        def round_trip():
            batch = []
            for st in states:
                n_img = int(st["embeds"].shape[0])
                ids, ids_cmp = self._ids_and_masks(st["prompt"], n_img)
                st["ids_len"] = len(ids)
                batch.append(dict(input_ids=ids, image_embeds=st["embeds"],
                                  embeds_cmp_mask=np.ones((n_img,), bool), ids_cmp_mask=ids_cmp))
            return self.generator.generate_batch(batch)

        outs = round_trip()
        # text-only endings surface once, then the story goes dormant
        finals: List[Optional[StorySegment]] = [None] * len(states)
        for r, (st, out) in enumerate(zip(states, outs)):
            if not out["has_img_output"]:
                finals[r] = StorySegment(0, self._clean(out["generate_ids"]), None, None,
                                         st["ids_len"])
                st["alive"] = False
        if any(f is not None for f in finals):
            yield finals

        while any(st["alive"] for st in states):
            segments: List[Optional[StorySegment]] = [None] * len(states)
            for r, (st, out) in enumerate(zip(states, outs)):
                if not st["alive"]:
                    continue
                feats = out["img_gen_feat"]
                image = self.detokenize(feats) if self.detokenize is not None else None
                text = self._clean(out["generate_ids"])
                segments[r] = StorySegment(st["text_id"], text, image, feats, st["ids_len"])
                st["embeds"] = torch.cat([st["embeds"], feats.to(st["embeds"].dtype)], dim=0)
                if (st["text_id"] >= cfg.story_len - 1
                        or st["embeds"].shape[0] >= cfg.story_len):
                    st["alive"] = False
                st["prompt"] = st["prompt"] + text + image_tokens
                st["text_id"] += 1
                while st["embeds"].shape[0] > cfg.window_size:  # sliding window
                    eoi_idx = st["prompt"].index(EOI_TOKEN)
                    st["prompt"] = st["prompt"][eoi_idx + len(EOI_TOKEN) + len("[INST]"):]
                    st["embeds"] = st["embeds"][1:]
            yield segments
            if not any(st["alive"] for st in states):
                return
            outs = round_trip()
            closing: List[Optional[StorySegment]] = [None] * len(states)
            for r, (st, out) in enumerate(zip(states, outs)):
                if st["alive"] and not out["has_img_output"]:
                    # the story ends without an image: its closing text
                    st["alive"] = False
                    closing[r] = StorySegment(st["text_id"], self._clean(out["generate_ids"]),
                                              None, None, st["ids_len"])
            if any(c is not None for c in closing):
                yield closing
