"""The multimodal attention-sink KV cache policy in PyTorch; counterpart of
``seed_story_tpu/decode/sink_cache.py``.

The reference policy (vis_george_sink, cache_mode 'img_head_tail'): when an
image leaves the window, permanently retain (a) the first 4 tokens of the
stream and (b) 12 tokens around its ``<img>`` (boi-4 .. boi+8) and 12 around
its ``</img>`` (eoi-8 .. eoi+4), ahead of the live tail, with the
reference's duplication of the 3 tokens where the ``</img>`` window
overlaps the tail. The host owns the token stream and computes the kept
slots; the device compacts each layer's buffers with one ``index_select``
over the capacity axis, the int8 scales riding with their tokens.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.llama import KVCache

FIRST_SINK = 4
BOI_BACK, BOI_FWD = 4, 8
EOI_BACK, EOI_FWD = 8, 4


def _compact(cache: KVCache, indices: torch.Tensor, new_len: int) -> KVCache:
    """Gathers capacity slots ``indices`` (length == capacity; the tail
    entries are don't-care) into new buffers, and sets every row's length
    to ``new_len``. Updates ``cache`` in place and returns it."""
    for shard in getattr(cache, "shards", [cache]):  # a tensor-parallel cache: every shard
        idx = indices.to(shard.k[0].device)
        gather = [shard.k, shard.v] + ([shard.k_scale, shard.v_scale] if shard.quantized else [])
        for buffers in gather:
            for i, buf in enumerate(buffers):
                buffers[i] = buf.index_select(2, idx)
    cache.length = [new_len] * len(cache.length)
    return cache


@dataclasses.dataclass
class SinkKVCacheManager:
    """Host-side bookkeeping for one streamed sequence (batch 1).

    Cache layout: slots [0, sink_len) hold retained sink tokens, [sink_len,
    length) the live (un-evicted) suffix, in order. The reference policy
    retains about 24-28 tokens per evicted image forever; ``max_sink``
    (beyond the reference) caps that growth by dropping the OLDEST
    per-image windows (the first-4 block always stays). ``sink_history``
    records ``sink_len`` after each eviction, for callers that report the
    sink's growth."""

    capacity: int
    max_sink: Optional[int] = None
    sink_len: int = 0
    _has_first_sink: bool = False
    # per-eviction retained window lengths, oldest first (without the
    # one-time first-4 block), for the max_sink cap
    _window_lens: List[int] = dataclasses.field(default_factory=list)
    sink_history: List[int] = dataclasses.field(default_factory=list)

    def evict_image_span(self, cache: KVCache, boi_idx: int, eoi_idx: int,
                         live_len: int) -> Tuple[KVCache, int]:
        """Evicts the live span [0, eoi_idx] (the oldest image block and
        everything before it), keeping the sink windows. ``boi_idx`` /
        ``eoi_idx`` index the live region (the host's ids without the
        sinks) of length ``live_len``. Returns the compacted cache and the
        number of live tokens dropped (eoi_idx + 1)."""
        s = self.sink_len
        keep: List[int] = list(range(s))  # the existing sink block
        first_len = 0
        if not self._has_first_sink:
            n_first = min(FIRST_SINK, live_len)
            keep += [s + i for i in range(n_first)]
            self._has_first_sink = True
            first_len = n_first
        elif self._window_lens:
            first_len = self.sink_len - sum(self._window_lens)

        lo = max(0, boi_idx - BOI_BACK)
        win = [s + i for i in range(lo, min(boi_idx + BOI_FWD, live_len))]
        lo = max(0, eoi_idx - EOI_BACK)
        win += [s + i for i in range(lo, min(eoi_idx + EOI_FWD, live_len))]
        keep += win
        self._window_lens.append(len(win))

        if self.max_sink is not None:
            while len(keep) > self.max_sink and len(self._window_lens) > 1:
                w = self._window_lens.pop(0)
                del keep[first_len:first_len + w]

        new_sink_len = len(keep)
        keep += [s + i for i in range(eoi_idx + 1, live_len)]  # the live tail
        new_len = len(keep)
        if new_len > self.capacity:
            raise ValueError(
                f"cache_capacity={self.capacity} too small: eviction still needs {new_len} "
                f"slots ({new_sink_len} sink + {new_len - new_sink_len} live). Size the cache "
                ">= prompt growth between evictions + the accumulated sink budget (~28 "
                "tokens per evicted image), or cap the sink with max_sink.")

        idx = np.zeros((self.capacity,), np.int64)
        idx[:new_len] = keep
        cache = _compact(cache, torch.from_numpy(idx), new_len)
        self.sink_len = new_sink_len
        self.sink_history.append(new_sink_len)
        return cache, eoi_idx + 1

    def truncate(self, cache: KVCache, total_len: int) -> KVCache:
        """Drops the entries past ``total_len`` (sink + live), the
        reference's ``kv[:, :, :prompt_len, :]``: sets every row's length."""
        cache.length = [total_len] * len(cache.length)
        return cache
