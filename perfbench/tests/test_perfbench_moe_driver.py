"""The mixture-of-experts story driver (``drivers/story_lockstep_moe.py``)
against its plain reference at a pico size on the CPU (the program's plain
kernels): a sound run comes out correct, and a run comes out not correct
when one held expert's output is scaled by 1.01, when the router's
correction bias is dropped, and with the control in the program's place.
The cell's readers: each reads nothing on an empty trace, kernel C's bounds
count the projections and the looped experts' launches, and a pico run under
torch's profiler feeds the readers of the program's spans and counters.

The cell's limits are set for its bf16 activations and int8 KV cache, where
a sound run flips a share of its routers' choices near ties. The pico runs
in float32 with a float KV cache, where a sound run flips none, so here
``route_mismatch`` is held to 0 (the other limits are the cell's), and the
check sees a 1% change in one expert through the choices of the layers after
it."""

from __future__ import annotations

import math
import time

import pytest
import torch

from perfbench import harness, roofline, roofline_moe
from perfbench import run as bench_run
from perfbench.tests.pico import AGENT
from seed_story_torch.models.moe import Router, RoutedExperts

KEXAONE = {"config": {"vocab_size": 32066, "padded_vocab_size": 32128, "hidden_size": 64,
                      "intermediate_size": 96, "num_hidden_layers": 5, "num_attention_heads": 4,
                      "num_key_value_heads": 2, "head_dim": 16,
                      "sliding_windows": [16, 16, 16, 0] * 12, "num_experts": 4,
                      "num_experts_per_tok": 2, "moe_intermediate_size": 32,
                      "deployment": {"published_num_experts": 8, "first_held_expert": 2},
                      "dtype": "float32", "quantize_kv": False,
                      "vit": AGENT["config"]["vit"], "agent": AGENT["config"]["agent"]},
           "traffic": {"stories": 4, "caption_words": [6, 8, 10, 12], "image_size": 56,
                       "new_tokens": 60, "force_boi_at": 36, "warmup_new_tokens": 40,
                       "warmup_boi_at": 8}}
SEEDS = (2147483901, 3000000017)


@pytest.fixture(autouse=True)
def float32_route_limit(monkeypatch):
    load = harness.driver

    def driver(name):
        module = load(name)
        module.LIMITS = dict(module.LIMITS, route_mismatch=0)
        return module

    monkeypatch.setattr(harness, "driver", driver)


def run_cell(seed: int, control: bool = False) -> dict:
    args = bench_run.parse(["--workload", "kexaone_story_b8", "--seed", str(seed), "--seconds",
                            "0.1", "--trace", "0", "--control", str(int(control))])
    return bench_run.run(args, device=torch.device("cpu"), t_start=time.perf_counter(),
                         overrides=KEXAONE)


@pytest.mark.parametrize("seed", SEEDS)
def test_a_sound_run_is_correct(seed):
    out = run_cell(seed)
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["attempted"] >= 4 and out["result"]["failed"] == 0


def test_one_held_expert_scaled_by_one_percent_fails(monkeypatch):
    forward = RoutedExperts.forward

    def scaled(self, h, order, offsets, top_k, grouped):
        y = forward(self, h, order, offsets, top_k, grouped)
        first = order[offsets[0]:offsets[1]].long()  # the pairs of held expert 0
        y[first] = y[first] * 1.01
        return y

    monkeypatch.setattr(RoutedExperts, "forward", scaled)
    out = run_cell(SEEDS[0])
    assert not out["result"]["correct"]
    assert not out["checks"]["route_mismatch"]["ok"]


def test_the_routing_bias_dropped_fails(monkeypatch):
    forward = Router.forward

    def unbiased(self, h):
        bias = self.e_score_correction_bias.data.clone()
        self.e_score_correction_bias.data.zero_()
        try:
            return forward(self, h)
        finally:
            self.e_score_correction_bias.data.copy_(bias)

    monkeypatch.setattr(Router, "forward", unbiased)
    out = run_cell(SEEDS[1])
    assert not out["result"]["correct"]
    assert not out["checks"]["route_mismatch"]["ok"]


def test_the_control_fails_a_compared_number():
    out = run_cell(SEEDS[0], control=True)
    assert not out["result"]["correct"], out["checks"]
    assert not all(c["ok"] for c in out["checks"].values())


# device_idle reads the busy share, which every trace has
READERS = sorted(m["name"] for m in harness.benchmark()["per_layer"]
                 if m["name"].endswith(".kexaone") and m["name"] != "device_idle.kexaone")
PROGRAM_SPAN_READERS = ["moe_route_host_ms.kexaone", "moe_expert_host_ms.kexaone",
                        "kv_write_host_ms.kexaone", "draft_acceptance.kexaone"]


def trace(**kw):
    base = dict(spans={}, records={}, kernels={}, busy_s=1.0, window_s=2.0, counters={},
                flops=0.0, idle_gaps=[], device_ops=[])
    base.update(kw)
    return harness.Trace(**base)


@pytest.mark.parametrize("metric", READERS)
def test_each_reader_reads_none_on_an_empty_trace(metric):
    from seed_story_torch.utils import tracing
    tracing.reset()
    assert harness.reader(metric)(trace(kernels={"k": [10, 1.0]})) is None


def test_kernel_c_bounds_count_the_projections_and_the_looped_experts():
    linear = [{"m": 40, "n": 8192, "k": 6144}, {"m": 5, "n": 8192, "k": 6144}]
    looped = {"grouped": False, "offsets": torch.tensor([0, 40, 45, 45, 80], dtype=torch.int32),
              "d": 6144, "i": 2048}
    grouped = dict(looped, grouped=True)
    got = roofline_moe.int8_gemm_bounds(linear, [looped, grouped])
    want = [roofline.int8_linear_bound(40, 8192, 6144)] + [
        b for m in (40, 35) for b in (roofline.int8_linear_bound(m, 4096, 6144),
                                      roofline.int8_linear_bound(m, 6144, 2048))]
    assert got == pytest.approx(want)
    t = trace(records={"int8_linear": linear, "experts": [looped, grouped]},
              kernels={"void int8_gemm_kernel<1>": [5, 10 * sum(want)]})
    assert harness.reader("int8_gemm_roofline.kexaone")(t) == pytest.approx(10.0)


def test_a_pico_run_under_the_profiler_feeds_the_program_span_readers():
    from seed_story_torch.utils import tracing
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert run_cell(SEEDS[1])["result"]["correct"]
    got = {m: harness.reader(m)(trace()) for m in PROGRAM_SPAN_READERS}
    assert all(v is not None and math.isfinite(v) for v in got.values()), got
    assert 0 <= got["draft_acceptance.kexaone"] <= 100
