"""The benchmark's general machinery: cells found by name, the measured
window, the traced run and its readers, the output check's report and the
result line.

A cell is ``workloads/<name>.json``: its configuration (``configs/<config>.json``),
its driver (``drivers/<driver>.py``, a ``Cell`` class) and its traffic. A
per-layer metric is ``layer_metrics/<metric>.py``, a ``read(trace)`` that
returns a number or None. Nothing here names a cell, a configuration or a
metric: later cells and metrics are files added beside these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "seed_story_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def _load(path: pathlib.Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return _load(HERE / "drivers" / f"{name}.py", f"perfbench_driver_{name}")


def reader(metric: str) -> Callable:
    return _load(HERE / "layer_metrics" / f"{metric}.py",
                 "perfbench_metric_" + metric.replace(".", "_")).read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def end_to_end_metrics(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def per_layer_metrics(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics of ``cell``: those listing it, and those without
    a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_metrics(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def derive(*parts) -> int:
    """A 63-bit seed from integers and strings, the same on every host."""
    h = 1469598103934665603
    for ch in repr(parts).encode():
        h = ((h ^ ch) * 1099511628211) % (1 << 64)
    return h >> 1


@dataclasses.dataclass
class Context:
    """What a driver's cell is built from."""
    cell: dict
    config: dict
    seed: int
    device: torch.device
    control: bool = False


# --- the measured window ------------------------------------------------------

@dataclasses.dataclass
class Request:
    start: float
    end: float
    units: float  # what the end-to-end rate counts
    answers: int  # answers the request returned
    failed: int  # of those, answers that came back without what was asked


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_window(request: Callable[[int], dict], seconds: float, device) -> List[Request]:
    """Whole requests until ``seconds`` have passed: the window closes at the
    end of the request that crosses the mark. Each request ends with the
    device synchronized, so its end is when its answer exists."""
    done: List[Request] = []
    t0 = time.perf_counter()
    i = 0
    while True:
        start = time.perf_counter()
        out = request(i)
        synchronize(device)
        end = time.perf_counter()
        done.append(Request(start, end, float(out["units"]), int(out["answers"]),
                            int(out.get("failed", 0))))
        i += 1
        if end - t0 >= seconds:
            return done


def window_seconds(done: List[Request]) -> float:
    return done[-1].end - done[0].start


# --- the traced run -----------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """What a traced window leaves for the per-layer readers."""
    spans: Dict[str, List[tuple]]  # name -> [(ms, meta)], timed by CUDA events
    records: Dict[str, List[dict]]  # kind -> shapes of calls, from forward hooks
    kernels: Dict[str, List[float]]  # device op name -> [count, seconds] in the window
    busy_s: float
    window_s: float
    counters: dict
    flops: float
    idle_gaps: List[list]
    device_ops: List[list]


class Tracer:
    """Forward hooks that time module calls with CUDA events (no
    synchronization: the event pair spans the call on the device's timeline)
    and record call shapes, and torch's profiler over the traced window.

    The traced window is the run's window, or the parts of it a driver
    chooses with ``pause`` / ``resume`` where a whole window's trace would
    take too long to read; the hooks record only while the profiler runs,
    and the parts' timelines are summed."""

    def __init__(self):
        self.spans = defaultdict(list)
        self.records = defaultdict(list)
        self.handles = []
        self.parts = []  # one timeline a traced part
        self.mark = None  # the open part's perfbench.window annotation
        self.read_s = [0.0, 0.0, 0.0, 0]  # profiler, events(), timeline seconds; events

    def span(self, module, name_of: Callable):
        """``name_of(args, kwargs)`` -> (span name, meta) or None."""
        stack = []

        def pre(mod, args, kwargs):
            got = name_of(args, kwargs) if self.mark is not None else None
            if got is None:
                stack.append(None)
                return
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rf = torch.profiler.record_function("perfbench." + got[0])
            rf.__enter__()
            stack.append((got[0], got[1], start, rf))

        def post(mod, args, kwargs, out):
            top = stack.pop()
            if top is not None:
                name, meta, start, rf = top
                rf.__exit__(None, None, None)
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.spans[name].append((start, end, meta))

        self.handles += [module.register_forward_pre_hook(pre, with_kwargs=True),
                         module.register_forward_hook(post, with_kwargs=True)]

    def record(self, module, kind: str, meta_of: Callable):
        """``meta_of(module, args, kwargs)`` -> a dict of the call's shapes or
        None, kept under ``kind``."""
        def pre(mod, args, kwargs):
            meta = meta_of(mod, args, kwargs) if self.mark is not None else None
            if meta is not None:
                self.records[kind].append(meta)

        self.handles.append(module.register_forward_pre_hook(pre, with_kwargs=True))

    def resume(self):
        """Starts a traced part: torch's profiler with its host side cut to
        user annotations (the ``perfbench.*`` marks), so the device's ops
        and the CUDA runtime's calls are recorded and the host's aten ops are
        not, and a ``perfbench.window`` mark over the part."""
        from torch._C._profiler import ProfilerActivity, RecordScope

        if self.mark is not None:
            return
        acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        config = torch.autograd.profiler.profile(use_device="cuda").config()
        torch.autograd._prepare_profiler(config, acts)
        torch.autograd._enable_profiler(config, acts, {RecordScope.USER_SCOPE})
        self.mark = torch.profiler.record_function("perfbench.window")
        self.mark.__enter__()

    def pause(self):
        """Ends the traced part and reads its timeline."""
        if self.mark is None:
            return
        self.mark.__exit__(None, None, None)
        self.mark = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = torch.autograd._disable_profiler()
        t1 = time.perf_counter()
        events = results.events()
        t2 = time.perf_counter()
        self.parts.append(timeline(events))
        r = self.read_s
        r[0], r[1], r[2] = r[0] + t1 - t0, r[1] + t2 - t1, r[2] + time.perf_counter() - t2
        r[3] += len(events)

    start = resume

    def stop(self, counters: dict, flops_of: Callable) -> Trace:
        self.pause()
        for h in self.handles:
            h.remove()
        spans = {name: [(s.elapsed_time(e), meta) for s, e, meta in calls]
                 for name, calls in self.spans.items()}
        kernels, gaps = defaultdict(lambda: [0, 0.0]), defaultdict(float)
        for part in self.parts:
            for name, (count, seconds) in part["kernels"].items():
                kernels[name][0] += count
                kernels[name][1] += seconds
            for label, seconds in part["gaps"].items():
                gaps[label] += seconds
        trace = Trace(spans=spans, records=dict(self.records), kernels=dict(kernels),
                      busy_s=sum(p["busy_s"] for p in self.parts),
                      window_s=sum(p["window_s"] for p in self.parts), counters=counters,
                      flops=0.0, idle_gaps=_top(gaps.items()),
                      device_ops=_top((n[:160], v[1]) for n, v in kernels.items()))
        if trace.busy_s <= 0:
            raise RuntimeError("the profiler recorded no device op")
        trace.flops = flops_of(trace)
        return trace

    def read_text(self) -> str:
        p, e, t, n = self.read_s
        return (f"{len(self.parts)} part(s): profiler {p:.1f} s, {n} events {e:.1f} s, "
                f"timeline {t:.1f} s")


def _top(items, n: int = 10) -> List[list]:
    return sorted(([k, v] for k, v in items), key=lambda x: -x[1])[:n]


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else 1000 * getattr(e, f"{what}_us")()


def timeline(events) -> dict:
    """From the profiler's raw events: the window (the span of the
    ``perfbench.window`` annotation), the device ops inside it by name, the
    union of their intervals (busy), and the idle gaps between them, each
    put to the innermost ``perfbench.*`` annotation the host was in at the
    gap's middle."""
    cuda = torch.autograd.DeviceType.CUDA
    device, marks = [], []
    for e in events:
        name = e.name()
        if name.startswith("perfbench."):  # the benchmark's own annotations
            if e.device_type() != cuda:  # (their copies on the device's timeline are no op)
                start = _ns(e, "start")
                marks.append((start, start + _ns(e, "duration"), name))
        elif e.device_type() == cuda:
            dur = _ns(e, "duration")
            if dur > 0:
                start = _ns(e, "start")
                device.append((start, start + dur, name))
    windows = [(a, b) for a, b, n in marks if n == "perfbench.window"]
    if not windows:
        raise RuntimeError("the profiler recorded no window")
    w0, w1 = windows[0]
    kernels = defaultdict(lambda: [0, 0.0])
    spans = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            kernels[name][0] += 1
            kernels[name][1] += (b - a) / 1e9
            spans.append((a, b))
    spans.sort()
    busy, gaps, cur = 0, [], None
    edge = w0
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            if a > edge:
                gaps.append((edge, a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
        edge = max(edge, b)
    if cur is not None:
        busy += cur[1] - cur[0]
    if w1 > edge:
        gaps.append((edge, w1))
    # one sweep: the gaps come in time order, so the marks open at a gap's
    # middle are those already started and not yet ended
    inner = sorted((m for m in marks if m[2] != "perfbench.window"), key=lambda m: m[0])
    by_label = defaultdict(float)
    nxt, open_marks = 0, []
    for a, b in gaps:
        mid = (a + b) / 2
        while nxt < len(inner) and inner[nxt][0] <= mid:
            open_marks.append(inner[nxt])
            nxt += 1
        open_marks = [m for m in open_marks if m[1] >= mid]
        best = min(open_marks, key=lambda m: m[1] - m[0], default=None)
        label = best[2] if best is not None else "outside the marked calls"
        by_label[label] += (b - a) / 1e9
    return {"kernels": dict(kernels), "busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "gaps": dict(by_label), "idle_gaps": _top(by_label.items()),
            "device_ops": _top((n[:160], v[1]) for n, v in kernels.items())}


# --- the report -----------------------------------------------------------------

def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def check(value: float, limit: float) -> dict:
    """One compared number beside its limit; passes when value <= limit."""
    ok = math.isfinite(value) and value <= limit
    return {"value": value, "limit": limit, "ok": bool(ok)}


def report(result: dict, checks: Dict[str, dict]) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line on standard output, ``checks`` its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    out = dict(result)
    out["checks"] = {n: {"value": c["value"], "limit": c["limit"]} for n, c in checks.items()}
    print(json.dumps(out), flush=True)


# --- helpers of the per-layer readers -------------------------------------------

def kernel_totals(trace: Trace, name: str):
    """(launches, device seconds) of the device ops whose name holds ``name``."""
    hits = [v for k, v in trace.kernels.items() if name in k]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def roofline_share(trace: Trace, kernel: str, bounds: list) -> Optional[float]:
    """Percent: the bounds of the calls the hooks saw over the kernel's
    device time. None when the kernel never ran or its launches and the
    calls disagree by more than 1% (the profiler may drop a few events; the
    recorded ones then stand for the rest)."""
    count, seconds = kernel_totals(trace, kernel)
    if not bounds or count == 0 or seconds <= 0 or abs(count - len(bounds)) > 0.01 * len(bounds):
        return None
    return 100.0 * sum(bounds) / (seconds * len(bounds) / count)


def span_mean_ms(trace: Trace, name: str) -> Optional[float]:
    calls = trace.spans.get(name, [])
    return sum(ms for ms, _ in calls) / len(calls) if calls else None


def idle_share(trace: Trace) -> Optional[float]:
    return 100.0 * (1.0 - trace.busy_s / trace.window_s) if trace.window_s > 0 else None


def mfu(trace: Trace) -> Optional[float]:
    """Percent of one chip's bf16 peak: the model FLOPs of the window's work
    over the traced window."""
    from perfbench.roofline import PEAK_BF16_FLOPS

    if trace.flops <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * trace.flops / (PEAK_BF16_FLOPS * trace.window_s)
