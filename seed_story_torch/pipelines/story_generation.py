"""Story generation pipeline (the gen_george flow) in PyTorch; counterpart
of ``StoryGenerationPipeline.run`` in
``seed_story_tpu/pipelines/story_generation.py``.

Seed with (image, caption); repeatedly: generate text and a forced image
block -> de-tokenize the regressed image features -> feed the GENERATED
features back as context -> while more than ``window_size`` images, strip
the oldest "...</img>[INST]" span from the prompt and drop its features.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..data.tokenizer import BOI_TOKEN, EOI_TOKEN, image_comprehension_string
from ..decode.generate import StoryGenerator

TAG_RE = re.compile(r"\s*<[^>]*>\s*")


@dataclasses.dataclass
class StoryPipelineConfig:
    story_len: int = 25
    window_size: int = 8
    num_img_in_tokens: int = 64
    instruction_prompt: str = "{instruction}"


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
