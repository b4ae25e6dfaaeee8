"""The port's own spans and counters, and points on a device's clock.

``span`` and ``count`` record only while a torch profiler records in the
calling thread: in this repo, the benchmark's ``--trace 1`` run
(``perfbench/``), whose per-layer metrics read :func:`records` and
:func:`counters`. There is no flag of their own, so they cover exactly the
parts a profile covers (a thread the profiler does not follow, such as one a
pool started, records nothing). Off, a site costs one check of the
profiler's state and builds nothing; a site that computes what it counts
asks :func:`recording` first. Nothing writes the store out: any other
profiler session fills it too, and it stays in memory in this process until
:func:`reset`.

A span never annotates the profile itself: a ``record_function`` leaves a
copy on the device's timeline that spans the kernels under it, and a reader
of that timeline would take it for device work. Its host times are on the
profiler's clock instead (nanoseconds since the epoch), so a record can be
laid over the profile's timeline.

A record holds the span's ``name``, its ``id``, its ``parent`` (the
innermost span open in the same thread when it started, or None) and its
host interval ``start_ns`` .. ``end_ns``.

Spans and counters of the port, each read by a per-layer metric of
``perfbench/``:

- per speculative pass ``decode.pass`` with children ``decode.draft``,
  ``decode.verify``, ``decode.sync`` and ``decode.accept``; counters
  ``decode.drafted`` and ``decode.accepted`` (``decode/generate.py``);
- ``llm.kv_write``: the new rows' quantize and writes into a KV cache
  (``models/llama.py``);
- per expert layer of a mixture of experts ``moe.route`` (the router, top-k
  and the dispatch's sort on the device) and ``moe.experts`` (the expert
  products and the weighted combine) (``models/moe.py``); in a verify pass
  both are children of ``decode.verify``. Routing counts live on the device
  and are no counter here: the benchmark's hooks keep them and read them
  after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

# whether a torch profiler records in this thread, torch's own check (about 150 ns)
recording = torch._C._autograd._profiler_enabled
# one pair of clock readings a process: perf_counter_ns() plus this is the
# profiler's clock, nanoseconds since the epoch
_EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
_OFF = contextlib.nullcontext()

_ids = itertools.count(1)
_local = threading.local()
_records: List["Record"] = []
_counters: Dict[str, int] = {}
_lock = threading.Lock()


def device_mark(device: torch.device):
    """A point on ``device``'s clock: a CUDA event recorded on its current
    stream (no synchronization until it is read), the host clock on the
    CPU."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event
    return time.perf_counter()


def seconds_between(marks) -> List[float]:
    """Seconds between consecutive :func:`device_mark` points; waits for
    the last one on a card."""
    if isinstance(marks[-1], float):
        return [b - a for a, b in zip(marks, marks[1:])]
    marks[-1].synchronize()
    return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]


def now_ns() -> int:
    """The host's time on the profiler's clock."""
    return time.perf_counter_ns() + _EPOCH_OFFSET_NS


@dataclasses.dataclass
class Record:
    """A span: entered as a context manager, kept once it exits."""
    name: str
    id: int
    parent: Optional[int] = None
    start_ns: int = 0
    end_ns: int = 0

    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def __enter__(self) -> "Record":
        stack = _stack()
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        self.start_ns = now_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = now_ns()
        _stack().pop()
        _records.append(self)
        return False


def _stack() -> List[Record]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str):
    """A context manager over a part of the program, recorded while a torch
    profiler records in this thread (a shared no-op context otherwise)."""
    if not recording():
        return _OFF
    return Record(name, next(_ids))


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while a torch profiler records in
    this thread."""
    if not recording():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def records() -> List[Record]:
    """The finished spans, in the order they ended."""
    return list(_records)


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Clears the records and the counters."""
    with _lock:
        _records.clear()
        _counters.clear()
