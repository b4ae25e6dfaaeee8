"""The benchmark of the PyTorch and CUDA port (``seed_story_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell named in ``perfbench/workloads/<cell>.json`` from the seed
(weights made on the device, inputs drawn by ``perfbench/traffic.py``), warms
up its shapes, runs whole requests for ``--seconds``, then checks what the
window produced against the plain float32 reference in
``perfbench/reference/`` and prints one JSON line: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiled window with the benchmark's hooks on. ``--control 1`` puts
the control (the reference one precision below the configuration's) in the
program's place for the check, which it has to fail; it is for setting and
testing the limits, and no measured run passes it.

Exits non-zero, printing no result, without a CUDA device or with fewer than
the cell asks for, or when jax, jaxlib, flax or seed_story_tpu is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# build and kernel caches stay inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".perfbench_cache" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".perfbench_cache" / "triton"))
os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
# one process with few host threads: the decode loop is paced by the host
HOST_THREADS = 2
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, str(HOST_THREADS))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, device=None, t_start: float = None, overrides: dict = None) -> dict:
    """One run of a cell; returns {"result": line, "checks": {...}}. ``device``
    None asks for the CUDA devices the cell needs (and exits without them);
    tests pass a CPU device and ``overrides`` ({"config": keys, "traffic":
    keys}) for a pico size."""
    t_start = T_START if t_start is None else t_start
    bench = harness.benchmark()
    cell = harness.workload(args.workload)
    overrides = overrides or {}
    cell["traffic"].update(overrides.get("traffic", {}))
    chips = cell["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise SystemExit(f"{args.workload} needs {chips} CUDA device(s); have "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    cfg = harness.config(cell["config"])
    cfg.update(overrides.get("config", {}))
    ctx = harness.Context(cell, cfg, args.seed, torch.device(device), bool(args.control))
    on_card = ctx.device.type == "cuda"
    cell_obj = harness.driver(cell["driver"]).Cell(ctx)
    harness.synchronize(ctx.device)
    setup_s = time.perf_counter() - t_start
    gc.collect()  # every window starts from a collected heap

    tracer = None
    if args.trace:
        tracer = harness.Tracer()
        cell_obj.instrument(tracer)
        tracer.start()
    done = harness.run_window(cell_obj.request, args.seconds, ctx.device)
    trace = None
    t_window = time.perf_counter()
    if tracer is not None:
        trace = tracer.stop(cell_obj.counters(), cell_obj.flops)
    harness.synchronize(ctx.device)
    t_trace = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(ctx.device) if on_card else 0

    metrics = {}
    if args.trace:
        for m in harness.per_layer_metrics(bench, args.workload):
            value = harness.reader(m["name"])(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in harness.end_to_end_metrics(bench, args.workload):
            value = setup_s if m["name"] == "setup_s" else cell_obj.end_to_end(m["name"], done)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = cell_obj.check()
    print(f"phases: set-up {setup_s:.1f} s, window {t_window - t_start - setup_s:.1f} s, "
          f"trace read {t_trace - t_window:.1f} s{f' ({tracer.read_text()})' if tracer else ''}, "
          f"check {time.perf_counter() - t_trace:.1f} s",
          file=sys.stderr, flush=True)
    failed = sum(r.failed for r in done)
    result = {
        "correct": bool(checks) and all(c["ok"] for c in checks.values()) and failed == 0,
        "attempted": sum(r.answers for r in done), "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else ctx.device.type,
                   "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
                   "count": chips if on_card else 0, "memory_peak_bytes": int(peak),
                   "power_limit": harness.power_limit() if on_card else None},
        "window_s": harness.window_seconds(done), "requests": len(done),
        "request_s": [r.end - r.start for r in done],
    }
    if trace is not None:
        result["device"]["busy_s"] = trace.busy_s
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}
    return {"result": result, "checks": checks}


def main(argv=None) -> int:
    args = parse(argv)
    torch.set_num_threads(HOST_THREADS)
    out = run(args)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr, flush=True)
        return 3
    harness.report(out["result"], out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
