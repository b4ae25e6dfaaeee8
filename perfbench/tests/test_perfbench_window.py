"""The window and rate arithmetic, the traced timeline and the per-layer
readers, on synthetic timings."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness, roofline


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_the_window_closes_at_the_end_of_the_request_that_crosses_the_mark(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)
    lengths = [4.0, 4.0, 4.0, 4.0, 4.0]

    def request(i):
        clock.t += lengths[i]
        return {"units": 10 * (i + 1), "answers": 2}

    done = harness.run_window(request, 10.0, "cpu")
    assert len(done) == 3  # ends at 12 s, the request that crossed 10 s
    assert harness.window_seconds(done) == pytest.approx(12.0)
    rate = sum(r.units for r in done) / harness.window_seconds(done)
    assert rate == pytest.approx(60 / 12.0)
    assert sum(r.answers for r in done) == 6


def test_a_request_longer_than_the_window_is_the_whole_window(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(harness.time, "perf_counter", clock)

    def request(i):
        clock.t += 30.0
        return {"units": 1, "answers": 1, "failed": 1}

    done = harness.run_window(request, 10.0, "cpu")
    assert len(done) == 1 and done[0].failed == 1
    assert harness.window_seconds(done) == pytest.approx(30.0)


class Event:
    def __init__(self, name, start_us, dur_us, cuda):
        self._n, self._s, self._d, self._c = name, start_us, dur_us, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int(self._d * 1000)

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU


def test_the_timeline_busy_share_gaps_and_ops():
    ev = [Event("perfbench.window", 0, 1000, False),
          Event("perfbench.request", 0, 1000, False),
          Event("perfbench.llm.verify", 100, 400, False),
          Event("perfbench.llm.verify", 100, 400, True),  # its copy on the device's timeline
          Event("kernel_a", 50, 100, True),   # 50-150
          Event("kernel_a", 120, 80, True),   # overlaps: 50-200
          Event("kernel_b", 600, 100, True),  # 600-700
          Event("kernel_b", 1900, 100, True)]  # outside the window
    t = harness.timeline(ev)
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx(250e-6)
    assert t["kernels"]["kernel_a"][0] == 2 and t["kernels"]["kernel_b"][0] == 1
    gaps = dict(t["idle_gaps"])
    # 0-50 and 700-1000 under the request alone, 200-600 inside the verify span
    assert gaps["perfbench.llm.verify"] == pytest.approx(400e-6)
    assert gaps["perfbench.request"] == pytest.approx(350e-6)
    assert t["device_ops"][0][0] == "kernel_a"


def trace(**kw):
    base = dict(spans={}, records={}, kernels={}, busy_s=0.25, window_s=1.0, counters={},
                flops=0.0, idle_gaps=[], device_ops=[])
    base.update(kw)
    return harness.Trace(**base)


def test_the_roofline_share_reads_nothing_when_launches_and_calls_disagree():
    bounds = [1e-3] * 100
    t = trace(kernels={"void int8_linear_kernel<4>": [100, 0.4]})
    assert harness.roofline_share(t, "int8_linear_kernel", bounds) == pytest.approx(25.0)
    t = trace(kernels={"void int8_linear_kernel<4>": [99, 0.396]})  # one event dropped
    assert harness.roofline_share(t, "int8_linear_kernel", bounds) == pytest.approx(25.0)
    t = trace(kernels={"void int8_linear_kernel<4>": [200, 0.4]})
    assert harness.roofline_share(t, "int8_linear_kernel", bounds) is None
    assert harness.roofline_share(trace(), "int8_linear_kernel", bounds) is None


def test_each_reader_on_a_synthetic_story_trace():
    t = trace(spans={"llm.verify": [(90.0, {}), (110.0, {})], "llm.prefill": [(200.0, {})]},
              counters={"decode_tokens": 24, "rows": 4}, flops=989e12 * 0.005)
    assert harness.reader("verify_pass_ms.story")(t) == pytest.approx(100.0)
    assert harness.reader("prefill_ms.story")(t) == pytest.approx(200.0)
    assert harness.reader("tokens_per_pass.story")(t) == pytest.approx(3.0)
    assert harness.reader("device_idle.story")(t) == pytest.approx(75.0)
    assert harness.reader("mfu.story")(t) == pytest.approx(0.5)
    assert harness.reader("int8_linear_roofline.story")(t) is None  # nothing to read


def test_the_bounds_from_shapes():
    # a 7B projection at 20 rows is bound by its weight bytes
    b = roofline.int8_linear_bound(20, 4096, 4096)
    assert b == pytest.approx((4096 * 4096 + 2 * 20 * 4096 + 4 * 4096 + 2 * 20 * 4096)
                              / roofline.PEAK_BYTES_PER_S)
    w = roofline.attention_work(1, 2, 2, 3, 5, 8, True, [2], [5])
    assert w["pairs"] == 2 * (3 + 4 + 5)
    w = roofline.attention_work(2, 2, 1, 4, 6, 8, False)
    assert w["pairs"] == 2 * 2 * 4 * 6 and w["kv"] == 2 * 2 * 6 * 8
    flops = roofline.llama_forward_flops(
        {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 1,
         "num_attention_heads": 2, "padded_vocab_size": 10}, [(0, 2)], 1)
    assert flops == 2 * (4 * 64 + 3 * 128) * 2 + 4 * 4 * 2 * 3 + 2 * 8 * 10


def test_each_idle_gap_goes_to_the_innermost_open_mark_over_many_marks():
    """Many requests, each with nested spans and kernels between them: every
    gap is put to the shortest mark open at its middle, as a scan of all the
    marks would put it."""
    ev = [Event("perfbench.window", 0, 100000, False)]
    for r in range(50):
        base = 2000 * r
        ev.append(Event("perfbench.request", base, 1800, False))
        for p in range(4):
            ev.append(Event("perfbench.llm.verify", base + 100 + 400 * p, 250, False))
            ev.append(Event("kernel_a", base + 150 + 400 * p, 50, True))
        ev.append(Event("kernel_b", base + 1900, 50, True))
    t = harness.timeline(ev)
    marks = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in ev
             if not e._c and e.name() != "perfbench.window"]
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in ev if e._c)
    want, edge = {}, 0
    for a, b in kernels + [(100000 * 1000, None)]:
        if a > edge:
            mid = (edge + a) / 2
            open_ = [m for m in marks if m[0] <= mid <= m[1]]
            name = min(open_, key=lambda m: m[1] - m[0])[2] if open_ else "outside the marked calls"
            want[name] = want.get(name, 0.0) + (a - edge) / 1e9
        edge = max(edge, b or edge)
    got = dict(t["idle_gaps"])
    assert set(got) == set(want)
    for name, seconds in want.items():
        assert got[name] == pytest.approx(seconds)


def test_the_traced_parts_add_up_and_a_part_may_hold_no_device_op():
    first = [Event("perfbench.window", 0, 1000, False), Event("kernel_a", 100, 300, True),
             Event("perfbench.llm.verify", 500, 400, False)]
    empty = [Event("perfbench.window", 5000, 20, False)]
    last = [Event("perfbench.window", 9000, 2000, False), Event("kernel_a", 9000, 500, True),
            Event("kernel_b", 10000, 250, True)]
    tracer = harness.Tracer()
    tracer.parts = [harness.timeline(ev) for ev in (first, empty, last)]
    t = tracer.stop({}, lambda trace: 0.0)
    assert t.window_s == pytest.approx(3020e-6)
    assert t.busy_s == pytest.approx(1050e-6)
    assert t.kernels["kernel_a"] == [2, pytest.approx(800e-6)]
    gaps = dict(t.idle_gaps)
    # a gap goes whole to the mark open at its middle: 400-1000 to the verify
    assert gaps["perfbench.llm.verify"] == pytest.approx(600e-6)
    assert gaps["outside the marked calls"] == pytest.approx((100 + 20 + 1250) * 1e-6)
    assert t.device_ops[0][0] == "kernel_a"


def test_the_hooks_record_only_while_a_part_is_traced():
    tracer = harness.Tracer()
    lin = torch.nn.Linear(2, 2)
    tracer.record(lin, "lin", lambda m, args, kwargs: {"rows": args[0].shape[0]})
    lin(torch.zeros(3, 2))
    tracer.mark = object()  # a part is open
    lin(torch.zeros(5, 2))
    tracer.mark = None
    lin(torch.zeros(7, 2))
    assert tracer.records["lin"] == [{"rows": 5}]
