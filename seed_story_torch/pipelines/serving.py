"""Pipelined two-stage story serving in PyTorch: decode and de-tokenization
overlap; counterpart of ``seed_story_tpu/pipelines/serving.py``.

The story flow feeds back the agent's OWN regressed image features as
context, never the de-tokenized pixels, so image synthesis is a pure sink
stage and can run beside the decode of the next round:

  decode:  round 1 ---- round 2 ---- round 3 ----
  detok:           img 1 ----- img 2 ----- img 3

- :class:`DetokenizerPool`: de-tokenizer replicas, one a device, each owned
  by one worker thread; ``submit`` round-robins and returns a Future, with
  one failover hop to the next replica. On a CUDA device a replica runs its
  work on a CUDA stream of its own, after the stream that produced the
  features, so its kernels can overlap the decode loop's on the same card.
- :class:`PipelinedStoryServer`: drives the lockstep decode
  (``StoryGenerationPipeline.run_batch``) and hands every produced feature
  to the pool without blocking the decode loop.
- :func:`pipelined_segments`: the same for one sequential story.
- :func:`split_devices`: the decode / de-tokenizer partition of the
  visible devices.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from .story_generation import StoryGenerationPipeline, StorySegment

log = logging.getLogger("seed_story_torch")


class DetokenizerPool:
    """Round-robin pool of de-tokenizer replicas.

    ``make_detok(device) -> (feats -> image)`` builds one replica whose
    weights live on ``device`` (a ``torch.device``); it is called once per
    device up front. Each replica is owned by a single worker thread, so a
    replica never runs two requests at once while different replicas run
    in parallel. ``busy_s`` and ``calls`` are per replica; ``failures``
    counts the calls that raised. A request whose replica raises goes once
    to the next replica; if that raises too, the Future raises.
    """

    def __init__(self, make_detok: Callable[[Any], Callable], devices: Sequence[Any]):
        if not devices:
            raise ValueError("DetokenizerPool needs at least one device")
        devices = [torch.device(d) for d in devices]
        self._replicas = [make_detok(d) for d in devices]
        # a CUDA replica computes on a stream of its own
        self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                         for d in devices]
        # one single-thread executor per replica: round-robin submission
        # can never double-book a replica
        self._executors = [ThreadPoolExecutor(1) for _ in self._replicas]
        self._rr = itertools.cycle(range(len(self._replicas)))
        self._lock = threading.Lock()
        self.busy_s = [0.0] * len(self._replicas)
        self.calls = [0] * len(self._replicas)
        self.failures = 0

    def __len__(self) -> int:
        return len(self._replicas)

    def submit(self, feats) -> Future:
        with self._lock:
            i = next(self._rr)
        # the replica's stream waits for the work that produced the features
        ready = None
        if isinstance(feats, torch.Tensor) and feats.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(feats.device))

        def call(j):
            stream = self._streams[j]
            if stream is None:
                return self._replicas[j](feats)
            with torch.cuda.stream(stream):
                if ready is not None:
                    stream.wait_event(ready)
                    if feats.device == stream.device:
                        feats.record_stream(stream)  # not reused while this stream reads it
                return self._replicas[j](feats)

        def work():
            # one failover hop: a story survives a single flaky replica
            n = len(self._replicas)
            tries = (i, (i + 1) % n) if n > 1 else (i,)  # no same-replica retry
            for attempt, j in enumerate(tries):
                try:
                    t0 = time.perf_counter()
                    out = call(j)
                    with self._lock:
                        self.busy_s[j] += time.perf_counter() - t0
                        self.calls[j] += 1
                    return out
                except Exception as e:  # noqa: BLE001
                    with self._lock:
                        self.failures += 1
                    if attempt + 1 == len(tries):
                        raise
                    log.warning("detokenizer replica %d failed (%s); retrying on replica %d",
                                j, type(e).__name__, tries[attempt + 1])

        return self._executors[i].submit(work)

    def shutdown(self):
        for ex in self._executors:
            ex.shutdown(wait=True)


class PipelinedStoryServer:
    """Overlaps the lockstep decode with pooled de-tokenization.

    ``pipeline`` must be built WITHOUT a detokenize hook (decode only); the
    server owns image synthesis. ``serve_stream`` yields ``(story_index,
    StorySegment)`` with each segment's ``image`` filled in by the pool, in
    the order the segments were decoded (so per story in segment order).
    """

    def __init__(self, pipeline: StoryGenerationPipeline, pool: DetokenizerPool):
        if pipeline.detokenize is not None:
            raise ValueError("PipelinedStoryServer owns de-tokenization; build the pipeline "
                             "with detokenize=None")
        self.pipeline = pipeline
        self.pool = pool
        # wall seconds of the serve_stream loops (decode + the consumer's time
        # while suspended at a yield) across all calls
        self.decode_s = 0.0

    def serve_stream(self, seeds: Sequence[Tuple[Any, str]]
                     ) -> Iterator[Tuple[int, StorySegment]]:
        pending: List[Tuple[int, StorySegment, Optional[Future]]] = []
        t0 = time.perf_counter()
        for round_segments in self.pipeline.run_batch(list(seeds)):
            # enqueue this round's images at once, then keep decoding
            for story_idx, seg in enumerate(round_segments):
                if seg is None:
                    continue
                fut = (self.pool.submit(seg.image_features)
                       if seg.image_features is not None else None)
                pending.append((story_idx, seg, fut))
            # FIFO drain: a later segment whose image finishes early never
            # overtakes an earlier one
            while pending and (pending[0][2] is None or pending[0][2].done()):
                story_idx, seg, fut = pending.pop(0)
                if fut is not None:
                    seg.image = fut.result()
                yield story_idx, seg
        self.decode_s += time.perf_counter() - t0
        for story_idx, seg, fut in pending:
            if fut is not None:
                seg.image = fut.result()
            yield story_idx, seg

    def serve(self, seeds: Sequence[Tuple[Any, str]]) -> List[List[StorySegment]]:
        """Runs every story to its end; returns per-story segment lists
        (ordered by segment index)."""
        stories: List[List[StorySegment]] = [[] for _ in seeds]
        for story_idx, seg in self.serve_stream(seeds):
            stories[story_idx].append(seg)
        for segs in stories:
            segs.sort(key=lambda s: s.index)
        return stories

    def stats(self) -> dict:
        return {"decode_s": round(self.decode_s, 3), "detok_replicas": len(self.pool),
                "detok_calls": list(self.pool.calls),
                "detok_busy_s": [round(b, 3) for b in self.pool.busy_s],
                "detok_failovers": self.pool.failures}


def pipelined_segments(segments: Iterator[StorySegment],
                       pool: DetokenizerPool) -> Iterator[StorySegment]:
    """Asynchronous de-tokenization for ONE sequential story: wraps any
    segment iterator built with ``detokenize=None`` (``run``, ``run_sink``,
    the visualization flow); each segment's features go to the pool while
    the iterator decodes the next segment, and the segments come out in
    order with their images filled in."""
    pending: List[Tuple[StorySegment, Optional[Future]]] = []
    for seg in segments:
        fut = pool.submit(seg.image_features) if seg.image_features is not None else None
        pending.append((seg, fut))
        while pending and (pending[0][1] is None or pending[0][1].done()):
            s, f = pending.pop(0)
            if f is not None:
                s.image = f.result()
            yield s
    for s, f in pending:
        if f is not None:
            s.image = f.result()
        yield s


def split_devices(n_decode: int, devices: Optional[Sequence[Any]] = None):
    """Partitions the devices (default: every visible CUDA device) into
    (decode_devices, detok_devices): the first ``n_decode`` decode, the rest
    each host one de-tokenizer replica."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not 0 < n_decode < len(devices):
        raise ValueError(f"need 1..{len(devices) - 1} decode devices, got {n_decode}")
    return devices[:n_decode], devices[n_decode:]
