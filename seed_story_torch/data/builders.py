"""Datapipe builders with the YAML surface of ``configs/data/*.yaml``; the
port's own copy of what it uses of ``seed_story_tpu/data/builders.py``:
``build_long_story_datapipe``, ``build_t2i_datapipe`` and
``build_multi_datapipes``, keyword for keyword."""

from __future__ import annotations

import functools
import random
from typing import List, Optional

from .datapipes import JsonlStoryDataset, batched
from .story_telling import StoryDecodeConfig, decode_long_story_sample, decode_t2i_sample


class StoryDataPipe:
    """Iterable of collated batches (or raw samples when batch_size=None),
    with the dataset's data-order state."""

    def __init__(self, dataset: JsonlStoryDataset, batch_size: Optional[int]):
        self.dataset = dataset
        self.batch_size = batch_size

    def __iter__(self):
        if self.batch_size is None:
            return iter(self.dataset)
        return batched(iter(self.dataset), self.batch_size)

    def state(self):
        return self.dataset.state()

    def set_state(self, state):
        self.dataset.set_state(state)


def build_long_story_datapipe(data_dir, image_dir, tokenizer=None, story_len=30, max_length=77,
                              batch_size=None, min_resolution=180, image_transform=None,
                              sd_image_transform=None, instruction_prompt="{instruction}",
                              turn_sep="\n",
                              system_message="", min_aspect_ratio=0.666, num_img_in_tokens=64,
                              num_img_out_tokens=64, cycle_count=None, seed=0,
                              max_images=None, host_index=None,
                              host_count=None) -> StoryDataPipe:
    """``turn_sep`` is accepted for the YAML surface and unused, as in the
    JAX package. ``host_index`` / ``host_count``: the files this process
    reads (None: its data shard, ``datapipes.shard_for_host``)."""
    cfg = StoryDecodeConfig(
        max_length=max_length, max_images=max_images or story_len,
        num_img_in_tokens=num_img_in_tokens, num_img_out_tokens=num_img_out_tokens,
        instruction_prompt=instruction_prompt, system_message=system_message,
        min_resolution=min_resolution, min_aspect_ratio=min_aspect_ratio)
    decode = functools.partial(decode_long_story_sample, image_dir=image_dir,
                               tokenizer=tokenizer, cfg=cfg, image_transform=image_transform,
                               sd_image_transform=sd_image_transform)
    ds = JsonlStoryDataset(data_dir, decode, cycle_count=cycle_count or 1, seed=seed,
                           host_index=host_index, host_count=host_count)
    return StoryDataPipe(ds, batch_size)


def build_t2i_datapipe(data_dir, image_dir, tokenizer=None, max_length=77, batch_size=None,
                       min_resolution=180, image_transform=None, sd_image_transform=None,
                       instruction_prompt="[INST] {instruction} [INST]\n", turn_sep="\n",
                       system_message="", min_aspect_ratio=0.666, num_img_in_tokens=64,
                       num_img_out_tokens=64, cycle_count=None, seed=0,
                       max_images: int = 1, host_index=None,
                       host_count=None) -> StoryDataPipe:
    """Text-to-image records (``decode_t2i_sample``); ``turn_sep`` is
    accepted for the YAML surface and unused, as in the JAX package;
    ``host_index`` / ``host_count`` as in ``build_long_story_datapipe``."""
    cfg = StoryDecodeConfig(
        max_length=max_length, max_images=max_images, num_img_in_tokens=num_img_in_tokens,
        num_img_out_tokens=num_img_out_tokens, system_message=system_message,
        min_resolution=min_resolution, min_aspect_ratio=min_aspect_ratio)
    decode = functools.partial(decode_t2i_sample, image_dir=image_dir, tokenizer=tokenizer,
                               cfg=cfg, image_transform=image_transform,
                               sd_image_transform=sd_image_transform,
                               instruction_prompt=instruction_prompt)
    ds = JsonlStoryDataset(data_dir, decode, cycle_count=cycle_count or 1, seed=seed,
                           host_index=host_index, host_count=host_count)
    return StoryDataPipe(ds, batch_size)


class MultiStoryDataPipe:
    """Seeded weighted mix of datapipes with data-order resume: each child
    fast-forwards through its own state, and the choice stream is drawn
    again ``draws`` times (children cycle, so none runs out mid-run)."""

    def __init__(self, pipes, weights, seed=0):
        self.pipes = list(pipes)
        self.weights = list(weights)
        self.seed = seed
        self._draws = 0
        self._pending_draws = 0

    def state(self):
        return {"draws": self._draws,
                "children": [p.state() if hasattr(p, "state") else None for p in self.pipes]}

    def set_state(self, state):
        self._pending_draws = int(state["draws"])
        for p, cs in zip(self.pipes, state.get("children", [])):
            if cs is not None and hasattr(p, "set_state"):
                p.set_state(cs)

    def __iter__(self):
        its = [iter(p) for p in self.pipes]
        weights = list(self.weights)
        rng = random.Random(self.seed)
        self._draws = 0
        for _ in range(self._pending_draws):
            rng.choices(range(len(its)), weights=weights, k=1)
            self._draws += 1
        self._pending_draws = 0
        while its:
            i = rng.choices(range(len(its)), weights=weights, k=1)[0]
            try:
                sample = next(its[i])
            except StopIteration:
                del its[i], weights[i]
                continue
            self._draws += 1
            yield sample


def build_multi_datapipes(datapipes: List, tokenizer=None, image_transform=None,
                          sd_image_transform=None, sample_weights=None, seed=0):
    """Weighted mix of ``datapipes``: dict configs (instantiated here, with
    the shared tokenizer and transforms) or built pipes."""
    from ..utils.config import instantiate

    built = [instantiate(dp, tokenizer=tokenizer, image_transform=image_transform,
                         sd_image_transform=sd_image_transform)
             if isinstance(dp, dict) else dp for dp in datapipes]
    if sample_weights is None:
        sample_weights = [1.0] * len(built)
    if len(sample_weights) != len(built):
        raise ValueError(f"{len(sample_weights)} weights for {len(built)} datapipes")
    return MultiStoryDataPipe(built, sample_weights, seed=seed)
