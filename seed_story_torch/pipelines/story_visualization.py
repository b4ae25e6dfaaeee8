"""Story visualization with the multimodal attention-sink KV cache in
PyTorch (the vis_george_sink flow); counterpart of
``seed_story_tpu/pipelines/story_visualization.py``.

Ground-truth texts, generated images. The KV cache persists across turns:
after each turn it is truncated back to the prompt (the generated tokens'
KV is dropped), only the new ``<img>...</img> + text`` suffix is prefilled
against it, and when more than ``window_size`` images are in context the
oldest image span is evicted by ``SinkKVCacheManager`` (one gather per
layer) and the host ids are cut to match.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional

import numpy as np

from ..data.tokenizer import BOI_TOKEN, EOI_TOKEN, image_comprehension_string
from ..decode.generate import StoryGenerator
from ..decode.sink_cache import SinkKVCacheManager
from .story_generation import StorySegment


@dataclasses.dataclass
class VisPipelineConfig:
    story_len: int = 25
    window_size: int = 8
    num_img_in_tokens: int = 64
    instruction_prompt: str = "{instruction}"


class StoryVisualizationPipeline:
    def __init__(self, tokenizer, generator: StoryGenerator, visual_encode: Callable,
                 detokenize: Optional[Callable] = None,
                 cfg: VisPipelineConfig = VisPipelineConfig()):
        self.tokenizer = tokenizer
        self.generator = generator
        self.visual_encode = visual_encode
        self.detokenize = detokenize
        self.cfg = cfg
        self._boi_id = tokenizer.encode(BOI_TOKEN, add_special_tokens=False)[0]
        self._eoi_id = tokenizer.encode(EOI_TOKEN, add_special_tokens=False)[0]

    def _cmp_mask(self, ids: np.ndarray, n_images: int) -> np.ndarray:
        boi = np.flatnonzero(ids == self._boi_id)
        eoi = np.flatnonzero(ids == self._eoi_id)
        mask = np.zeros(len(ids), bool)
        for i in range(n_images):
            mask[boi[i] + 1:eoi[i]] = True
        return mask

    def run(self, image_pixels: np.ndarray, starting_text: str,
            texts: List[str]) -> Iterator[StorySegment]:
        """image_pixels: (1, 3, H, W) start frame; ``texts[i]`` is the text of
        segment i + 1. Needs a generator built with ``return_cache=True``.
        ``self.sink`` is the run's ``SinkKVCacheManager``."""
        cfg, tok = self.cfg, self.tokenizer
        if not self.generator.cfg.return_cache:
            raise ValueError("the visualization flow threads the KV cache; build the "
                             "StoryGenerator with return_cache=True")
        image_tokens = image_comprehension_string(cfg.num_img_in_tokens)
        prompt = (cfg.instruction_prompt.format_map({"instruction": starting_text + image_tokens})
                  + texts[0])
        live_ids = np.asarray([tok.bos_token_id] + tok.encode(prompt, add_special_tokens=False),
                              np.int64)
        n_images = 1
        sink = self.sink = SinkKVCacheManager(capacity=self.generator.cfg.cache_capacity)
        out = self.generator.generate(live_ids, self.visual_encode(image_pixels),
                                      np.ones((1,), bool),
                                      self._cmp_mask(live_ids, n_images))
        cache_live_len = len(live_ids)

        text_id = 1
        while out["has_img_output"] and n_images < cfg.story_len:
            feats = out["img_gen_feat"]
            image = self.detokenize(feats) if self.detokenize is not None else None
            yield StorySegment(text_id, texts[text_id - 1], image, feats,
                               sink.sink_len + len(live_ids))

            n_images += 1
            if text_id >= min(cfg.story_len - 1, len(texts)):
                return
            text = texts[text_id]
            text_id += 1

            # drop the generated tokens' KV, keep sink + live prompt
            cache = sink.truncate(out["cache"], sink.sink_len + cache_live_len)

            # append the new image block and the next text
            suffix_ids = np.asarray(tok.encode(image_tokens + text, add_special_tokens=False),
                                    np.int64)
            suffix_start = len(live_ids)
            live_ids = np.concatenate([live_ids, suffix_ids])

            while n_images > cfg.window_size:  # sink evictions
                boi = int(np.flatnonzero(live_ids == self._boi_id)[0])
                eoi = int(np.flatnonzero(live_ids == self._eoi_id)[0])
                cache, dropped = sink.evict_image_span(cache, boi, eoi, live_len=cache_live_len)
                live_ids = live_ids[dropped:]
                suffix_start -= dropped
                cache_live_len -= dropped
                n_images -= 1

            # prefill ONLY the new suffix against the carried cache
            suffix = live_ids[suffix_start:]
            out = self.generator.generate(suffix, feats, np.ones((1,), bool),
                                          self._cmp_mask(suffix, 1), cache=cache)
            cache_live_len = len(live_ids)
