"""The one traffic generator: a cell's ``traffic`` parameters and a seed in,
the inputs of its requests out. Every seed gets the same set of sizes (caption
lengths, feature shapes); the seed orders them and draws the values, except
where the values set the work (a story's text under speculation), which a
cell's ``content_seed`` fixes.

- ``story_starts``: one (start image, caption) pair per story of a lockstep
  batch; CLIP-normalized pixels drawn as standard normals, captions of
  ``caption_words`` words drawn from WORDS; fixed by the cell's
  ``content_seed``.
- ``feature_sets``: a de-tokenizer call's image features (``images_per_call``
  sets of ``feature_tokens`` x ``feature_dim`` standard normals, drawn on the
  device) and the seed of its initial latent noise.
- ``negatives``: the classifier-free guidance negatives of a run (one feature
  set, the same for every image, as a black image's features are).
"""

from __future__ import annotations

import numpy as np
import torch

WORDS = ("george", "the", "monkey", "went", "to", "park", "man", "with", "yellow", "hat",
         "baked", "a", "cake", "found", "red", "kite", "on", "beach", "parade", "marched",
         "through", "city", "at", "night", "dog", "ran", "after", "ball", "in", "garden",
         "rain", "fell", "over", "old", "town", "they", "climbed", "tall", "tree", "and",
         "saw", "big", "ship", "sail", "away", "friends", "shared", "lunch", "by", "river",
         "bright", "moon", "rose", "above", "quiet", "hills", "children", "sang", "song",
         "near", "fire", "small", "bird", "flew")


def _rng(seed: int, *parts) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *[hash_part(p) for p in parts]])


def hash_part(p) -> int:
    h = 0
    for ch in str(p).encode():
        h = (h * 257 + ch) % (1 << 61)
    return h


def story_starts(traffic: dict):
    """[(pixels (1, 3, S, S) float32 numpy, caption str)] for the batch's
    rows: a fixed set drawn from the traffic's ``content_seed``. What a
    speculative decode costs depends on the text it produces, and at a near
    tie even a story's row in the batch flips a token, so every seed gets
    the same stories in the same rows."""
    rng = _rng(traffic["content_seed"], "stories")
    lengths = list(traffic["caption_words"])
    size = traffic["image_size"]
    stories = []
    for r in range(traffic["stories"]):
        caption = " ".join(WORDS[i] for i in rng.integers(0, len(WORDS),
                                                           lengths[r % len(lengths)]))
        stories.append((rng.standard_normal((1, 3, size, size), dtype=np.float32), caption))
    return stories


def feature_sets(traffic: dict, seed: int, call: int, device, dtype=torch.bfloat16):
    """(features (images_per_call, tokens, dim) on ``device``, noise seed)."""
    s = int(_rng(seed, "features", call).integers(0, 1 << 62))
    gen = torch.Generator(device=device).manual_seed(s)
    shape = (traffic["images_per_call"], traffic["feature_tokens"], traffic["feature_dim"])
    feats = torch.randn(shape, generator=gen, device=device, dtype=torch.float32).to(dtype)
    return feats, int(_rng(seed, "noise", call).integers(0, 1 << 62))


def negatives(traffic: dict, seed: int, device, dtype=torch.bfloat16):
    gen = torch.Generator(device=device).manual_seed(
        int(_rng(seed, "negatives").integers(0, 1 << 62)))
    one = torch.randn((1, traffic["feature_tokens"], traffic["feature_dim"]), generator=gen,
                      device=device, dtype=torch.float32).to(dtype)
    return one.expand(traffic["images_per_call"], -1, -1).contiguous()
