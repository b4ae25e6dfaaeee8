"""Metrics, logging and profiling of a training run; counterpart of
``seed_story_tpu/train/metrics.py``.

  * ``MetricsWriter``: one JSON line per logged step in
    ``<logdir>/metrics.jsonl``, and tensorboard scalars as well when
    tensorboardX can be imported;
  * ``Profiler``: ``torch.profiler`` over the steps
    ``profile_start`` .. ``profile_stop``, written as a Chrome trace and a
    kernel table;
  * ``Throughput``: steps/s for the progress line.

The parts of a step are timed on the device's clock by
``utils/tracing.py::device_mark`` / ``seconds_between``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import torch

log = logging.getLogger("seed_story_torch")


def setup_logging():
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
                        datefmt="%m/%d/%Y %H:%M:%S", force=True)
    return log


class MetricsWriter:
    def __init__(self, logdir: str, config: Optional[Dict] = None):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(logdir)
        if config is not None:
            with open(os.path.join(logdir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: Dict[str, float], step: int):
        metrics = {k: float(v) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": step, **metrics}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class Profiler:
    """Traces the steps after ``start_step`` up to ``stop_step`` (step
    numbers as the runner counts them, from 1)."""

    def __init__(self, logdir: str, start_step: int = -1, stop_step: int = -1):
        self.logdir = logdir
        self.start_step, self.stop_step = start_step, stop_step
        self._prof: Optional[torch.profiler.profile] = None

    def maybe_step(self, step: int):
        if step == self.start_step and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif step == self.stop_step and self._prof is not None:
            self.close()

    def close(self):
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(self.logdir, "profile_trace.json"))
        sort = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
        with open(os.path.join(self.logdir, "profile_kernels.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=40))


class Throughput:
    """Steps/s as an exponential moving average."""

    def __init__(self):
        self._last = time.perf_counter()
        self._ema: Optional[float] = None

    def tick(self) -> Dict[str, float]:
        now = time.perf_counter()
        sps = 1.0 / max(now - self._last, 1e-9)
        self._last = now
        self._ema = sps if self._ema is None else 0.9 * self._ema + 0.1 * sps
        return {"steps_per_sec": self._ema}

