"""What the readers of the program's own spans and counters share: the store
of ``seed_story_torch.utils.tracing`` in this process, filled while the
traced run's profiler recorded. A program without that module (an older
checkout) has nothing to read: every function here then returns nothing, and
the readers None."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


def _tracing():
    try:
        from seed_story_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def spans(name: str) -> list:
    """The program's finished spans named ``name``."""
    tracing = _tracing()
    return [] if tracing is None else [r for r in tracing.records() if r.name == name]


def counter(name: str) -> Optional[int]:
    tracing = _tracing()
    return None if tracing is None else tracing.counters().get(name)


def with_children(parent: str, *children: str) -> List[Tuple[object, float]]:
    """Each span named ``parent``, with the host ms of its direct children
    named in ``children`` summed."""
    tracing = _tracing()
    if tracing is None:
        return []
    recs = tracing.records()
    sums = {r.id: 0.0 for r in recs if r.name == parent}
    for r in recs:
        if r.name in children and r.parent in sums:
            sums[r.parent] += r.host_ms()
    return [(r, sums[r.id]) for r in recs if r.id in sums]


def mean(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None
