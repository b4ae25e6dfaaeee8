"""Host-side data pipeline: jsonl shards -> seeded shuffles -> decoded,
statically batched numpy batches, and a background-thread loader; the
port's own copy of what it uses of ``seed_story_tpu/data/datapipes.py``.
The stream is a pure function of (seed, records consumed), so a restored
position replays it exactly.
"""

from __future__ import annotations

import glob
import inspect
import itertools
import json
import os
import queue
import random
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .story_telling import collate


def _list_files(data_dir, suffix: str, recursive: bool) -> List[str]:
    if isinstance(data_dir, (list, tuple)):
        return sorted(f for d in data_dir for f in _list_files(d, suffix, recursive))
    if os.path.isfile(data_dir):
        return [data_dir]
    pattern = f"**/*{suffix}" if recursive else f"*{suffix}"
    return sorted(glob.glob(os.path.join(data_dir, pattern), recursive=recursive))


def list_jsonl_files(data_dir, recursive: bool = True) -> List[str]:
    """The .jsonl files under ``data_dir`` (a file, a directory or a list of
    either), sorted; ``recursive`` descends into subdirectories."""
    return _list_files(data_dir, ".jsonl", recursive)


def list_tar_files(data_dir, recursive: bool = True) -> List[str]:
    """The .tar shards under ``data_dir``, as :func:`list_jsonl_files`."""
    return _list_files(data_dir, ".tar", recursive)


def parse_jsonl(path: str) -> Iterator[Dict[str, Any]]:
    """Yields records, skipping bad lines and unreadable files."""
    try:
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue
    except OSError:
        return


def iter_tar_members(paths: Iterable[str], mode: str = "r:*") -> Iterator[tuple]:
    """``(inner path, bytes)`` of every file member of every tar shard. A
    corrupt shard ends that shard with a warning, never the stream (the
    reference's TarArchiveLoaderWoException)."""
    import tarfile
    import warnings

    if isinstance(paths, str):
        paths = [paths]
    for pathname in paths:
        try:
            with tarfile.open(pathname, mode=mode) as tar:
                for tarinfo in tar:
                    if not tarinfo.isfile():
                        continue
                    fobj = tar.extractfile(tarinfo)
                    if fobj is None:
                        warnings.warn(f"failed to extract file {tarinfo.name} from source "
                                      f"tarfile {pathname}")
                        raise tarfile.ExtractError
                    yield os.path.normpath(os.path.join(pathname, tarinfo.name)), fobj.read()
        except Exception as e:  # noqa: BLE001 -- a bad shard is skipped, as in the reference
            warnings.warn(f"Unable to extract files from corrupted tarfile stream {pathname} "
                          f"due to: {e}, abort!")


def shard_for_host(items: Sequence, host_index: Optional[int] = None,
                   host_count: Optional[int] = None) -> List:
    """Every ``host_count``-th item from ``host_index``; both default to this
    process's data shard (``parallel.collectives.data_shard``: its rank and
    the world size in an initialized process group, else 0 and 1), as the
    JAX function defaults to the process index and count."""
    if host_index is None or host_count is None:
        from ..parallel.collectives import data_shard

        host_index, host_count = data_shard()
    return list(items)[host_index::host_count]


class JsonlStoryDataset:
    """Deterministic iterable over decoded samples. One epoch is one pass
    over (files x cycle_count) with seeded shuffles; ``host_index`` /
    ``host_count`` take every n-th file (:func:`shard_for_host`; None: this
    process's data shard, so the ranks of a run read disjoint files)."""

    def __init__(self, data_dir,
                 decode_fn: Callable[..., Optional[Dict[str, np.ndarray]]], *,
                 cycle_count: int = 1, seed: int = 0, host_index: Optional[int] = None,
                 host_count: Optional[int] = None, shuffle_buffer: int = 256):
        self.files = list_jsonl_files(data_dir)
        if not self.files:
            raise FileNotFoundError(f"no .jsonl under {data_dir}")
        self.decode_fn = decode_fn
        self.cycle_count = cycle_count
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count
        self.shuffle_buffer = shuffle_buffer
        # the decode's own draws are seeded by (seed, record position) too
        try:
            self._decode_takes_rng = "rng" in inspect.signature(decode_fn).parameters
        except (TypeError, ValueError):
            self._decode_takes_rng = False
        self._records_consumed = 0
        self._skip = 0

    def state(self) -> Dict[str, int]:
        return {"seed": self.seed, "records_consumed": self._records_consumed}

    def set_state(self, state: Dict[str, int]) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(f"data state of seed {state['seed']}, dataset seed {self.seed}")
        self._records_consumed = 0
        self._skip = int(state["records_consumed"])

    def _emit(self, record):
        """Counts the record; decodes it unless fast-forwarding."""
        self._records_consumed += 1
        if self._skip > 0:
            self._skip -= 1
            return None
        if self._decode_takes_rng:
            rng = random.Random(f"{self.seed}:decode:{self._records_consumed - 1}")
            return self.decode_fn(record, rng=rng)
        return self.decode_fn(record)

    def _file_stream(self, epoch: int) -> List[str]:
        rng = random.Random(f"{self.seed}:files:{epoch}")
        files = list(self.files)
        rng.shuffle(files)
        files = files * self.cycle_count
        rng.shuffle(files)
        return shard_for_host(files, self.host_index, self.host_count)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # every __iter__ restarts the stream at epoch 0, and the position with
        # it (a pending set_state fast-forward is kept)
        self._records_consumed = 0
        for epoch in itertools.count():
            rng = random.Random(f"{self.seed}:sample:{epoch}")
            buf: List[Dict[str, Any]] = []
            for path in self._file_stream(epoch):
                for record in parse_jsonl(path):
                    buf.append(record)
                    if len(buf) >= self.shuffle_buffer:
                        idx = rng.randrange(len(buf))
                        buf[idx], buf[-1] = buf[-1], buf[idx]
                        sample = self._emit(buf.pop())
                        if sample is not None:
                            yield sample
            rng.shuffle(buf)
            for record in buf:
                sample = self._emit(record)
                if sample is not None:
                    yield sample


def sample_multiplexer(pipes: Sequence[Iterable], weights: Optional[Sequence[float]] = None,
                       seed: int = 0) -> Iterator:
    """Seeded weighted interleave of ``pipes`` (torchdata's
    SampleMultiplexer); an exhausted pipe drops out of the draw."""
    iters = [iter(p) for p in pipes]
    weights = [1.0] * len(iters) if weights is None else list(weights)
    rng = random.Random(seed)
    while iters:
        i = rng.choices(range(len(iters)), weights=weights, k=1)[0]
        try:
            yield next(iters[i])
        except StopIteration:
            del iters[i], weights[i]


def batched(samples: Iterable, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
    """Collated batches of ``batch_size``; a ragged tail is dropped."""
    it = iter(samples)
    while True:
        batch = list(itertools.islice(it, batch_size))
        if len(batch) < batch_size:
            return
        yield collate(batch)


class ThreadedLoader:
    """Background-thread pipeline with a bounded prefetch queue. Batches are
    produced (and moved to the device by ``device_put_fn``) off the
    trainer's thread. ``state_fn()`` is taken right after each batch is
    produced and travels with it, so ``current_state`` describes the
    batches the consumer has seen, not the producer's position."""

    _SENTINEL = object()

    def __init__(self, batch_iter_factory: Callable[[], Iterator], prefetch: int = 2,
                 device_put_fn: Optional[Callable] = None,
                 state_fn: Optional[Callable[[], Dict]] = None):
        self.factory = batch_iter_factory
        self.device_put_fn = device_put_fn
        self.state_fn = state_fn
        self.current_state: Optional[Dict] = None
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self.factory():
                if self._stop.is_set():
                    return
                snap = self.state_fn() if self.state_fn is not None else None
                if self.device_put_fn is not None:
                    batch = self.device_put_fn(batch)
                self._q.put((batch, snap))
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                return
            batch, self.current_state = item
            yield batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
