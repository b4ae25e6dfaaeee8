"""The readers of the program's own spans and counters
(``seed_story_torch.utils.tracing``), on a synthetic store on a fake clock:
children subtracted, sums a pass, the ratios; None on an empty store and on
a program without the module; the VAE decode from the benchmark's own hook
span; a ``--trace 0`` run at a pico size that leaves the store empty, and a
story run under torch's profiler that every story reader reads."""

from __future__ import annotations

import contextlib
import math
import sys

import pytest
import torch

import seed_story_torch.utils
from perfbench import harness
from perfbench.tests import pico
from seed_story_torch.utils import tracing

STORY = ["pass_host_ms.story", "accept_host_ms.story", "verify_enqueue_ms.story",
         "kv_write_host_ms.story", "sync_wait_ms.story", "draft_acceptance.story",
         "device_ops_per_pass.story"]
DETOK = ["vae_decode_ms.detok"]


def trace(kernels=None, spans=None):
    return harness.Trace(spans=spans or {}, records={}, kernels=kernels or {}, busy_s=1.0,
                         window_s=2.0, counters={}, flops=0.0, idle_gaps=[], device_ops=[])


class Clock:
    """The host's and the device's clock of the fake store, in ms."""

    def __init__(self, monkeypatch):
        self.ms = 0.0
        monkeypatch.setattr(tracing, "recording", lambda: True)
        monkeypatch.setattr(tracing, "now_ns", lambda: int(round(self.ms * 1e6)))

    @contextlib.contextmanager
    def span(self, name, start, end):
        self.ms = start
        with tracing.span(name):
            yield
            self.ms = end


@pytest.fixture(autouse=True)
def empty_store():
    tracing.reset()
    yield
    tracing.reset()


def story_store(clock):
    """Two passes, their parts, and the prefill's cache writes (under no
    verify)."""
    with clock.span("llm.kv_write", 1, 191):
        pass
    for t0, draft, verify, kv, sync, accept in (
            (200, 202, (202, 290), [(210, 213), (220, 222)], (290, 295), (295, 299)),
            (300, 301, (301, 381), [(310, 313)], (381, 391), (391, 399))):
        with clock.span("decode.pass", t0, t0 + 100):
            with clock.span("decode.draft", t0, draft):
                pass
            with clock.span("decode.verify", *verify):
                for a, b in kv:
                    with clock.span("llm.kv_write", a, b):
                        pass
            with clock.span("decode.sync", *sync):
                pass
            with clock.span("decode.accept", *accept):
                pass
    tracing.count("decode.drafted", 32)
    tracing.count("decode.accepted", 8)


def test_each_story_reader_on_a_synthetic_store(monkeypatch):
    story_store(Clock(monkeypatch))
    t = trace({"void int8_linear_kernel<4>": [2000, 1.0], "copy": [402, 0.1]})
    got = {m: harness.reader(m)(t) for m in STORY}
    assert got == {
        "pass_host_ms.story": pytest.approx(100.0),
        # drafts and acceptance, summed a pass: (2 + 4) and (1 + 8)
        "accept_host_ms.story": pytest.approx(7.5),
        # each verify less its cache writes: 88 - 5 and 80 - 3 (the prefill's are not a pass's)
        "verify_enqueue_ms.story": pytest.approx(80.0),
        "kv_write_host_ms.story": pytest.approx(4.0),
        "sync_wait_ms.story": pytest.approx((5 + 10) / 2),
        "draft_acceptance.story": pytest.approx(25.0),
        "device_ops_per_pass.story": pytest.approx(1201.0)}


def test_the_vae_decode_reader_reads_the_benchmarks_hook_span():
    t = trace(spans={"vae_decode": [(290.0, {"b": 4}), (310.0, {"b": 4})],
                     "unet": [(185.0, {"b": 8})]})
    assert harness.reader("vae_decode_ms.detok")(t) == pytest.approx(300.0)


@pytest.mark.parametrize("metric", STORY + DETOK)
def test_each_reader_reads_none_on_an_empty_store(metric):
    assert harness.reader(metric)(trace({"k": [10, 1.0]})) is None


@pytest.mark.parametrize("metric", STORY + DETOK)
def test_each_reader_reads_none_where_the_program_has_no_tracing_module(monkeypatch, metric):
    clock = Clock(monkeypatch)
    story_store(clock)
    monkeypatch.setitem(sys.modules, "seed_story_torch.utils.tracing", None)
    monkeypatch.delattr(seed_story_torch.utils, "tracing")
    assert harness.reader(metric)(trace({"k": [10, 1.0]})) is None


@pytest.mark.parametrize("cell", ["agent_story_b4", "detok_1024_b4"])
def test_a_run_without_the_profiler_leaves_the_store_empty(cell):
    out = pico.run_cell(cell, seed=2**31 + 11)
    assert out["result"]["correct"]
    assert tracing.records() == [] and tracing.counters() == {}


def test_a_pico_run_under_the_profiler_feeds_every_reader():
    """The story cell's program at a pico size on the CPU under torch's
    profiler: every story reader reads a finite number, and a pass's parts
    add up to no more than the pass."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert pico.run_cell("agent_story_b4", seed=2**31 + 12)["result"]["correct"]
    t = trace({"op": [1000, 1.0]})
    got = {m: harness.reader(m)(t) for m in STORY}
    assert all(v is not None and math.isfinite(v) for v in got.values()), got
    parts = sum(got[m] for m in ("verify_enqueue_ms.story", "kv_write_host_ms.story",
                                 "accept_host_ms.story", "sync_wait_ms.story"))
    assert 0.9 * got["pass_host_ms.story"] < parts <= got["pass_host_ms.story"]
    assert 0 <= got["draft_acceptance.story"] <= 100
