"""The port's own spans and counters (``seed_story_torch.utils.tracing``),
on the CPU: they record only while a torch profiler records, nest by thread
with parent ids, keep their host times on the profiler's clock and leave no
event in the profile; the speculative decode loop's spans and counters add
up, and change no generated id."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from seed_story_torch.data.tokenizer import BOI_TOKEN_ID, EOI_TOKEN_ID, FIRST_IMG_TOKEN_ID
from seed_story_torch.decode.generate import GenerateConfig, StoryGenerator
from seed_story_torch.inference.common import quantize_agent_
from seed_story_torch.models.agent import AgentConfig, ContinuousLVLM
from seed_story_torch.utils import tracing

K = 4
PROGRAM_PREFIXES = ("seed_story.", "decode.", "llm.")


@pytest.fixture(autouse=True)
def empty_store():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.reset()
    yield
    tracing.reset()
    torch.set_num_threads(threads)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(name):
    return [r for r in tracing.records() if r.name == name]


def test_without_a_profiler_nothing_is_recorded():
    with tracing.span("decode.pass"):
        with tracing.span("llm.kv_write"):
            tracing.count("decode.drafted")
    assert not tracing.recording()
    assert tracing.records() == [] and tracing.counters() == {}


def test_nested_spans_keep_their_parent_on_the_profilers_clock():
    with cpu_profile() as prof:
        with record_function("enclosing"):
            time.sleep(0.02)
            with tracing.span("outer") as outer:
                with tracing.span("inner") as inner:
                    with tracing.span("leaf") as leaf:
                        time.sleep(0.002)
                tracing.count("things", 2)
                tracing.count("things")
            time.sleep(0.02)
    assert outer.parent is None and inner.parent == outer.id and leaf.parent == inner.id
    assert len({outer.id, inner.id, leaf.id}) == 3
    assert [r.name for r in tracing.records()] == ["leaf", "inner", "outer"]
    assert tracing.counters() == {"things": 3}
    assert outer.start_ns <= inner.start_ns <= leaf.start_ns < leaf.end_ns <= outer.end_ns
    assert leaf.host_ms() >= 2.0
    # the span lies inside the profiler's event that encloses it (epoch ns)
    ev = [e for e in prof.profiler.kineto_results.events() if e.name() == "enclosing"]
    assert len(ev) == 1
    start, end = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    assert start < outer.start_ns and outer.end_ns < end


def test_device_marks_on_the_cpu_read_the_host_clock():
    cpu = torch.device("cpu")
    marks = [tracing.device_mark(cpu)]
    time.sleep(0.002)
    marks.append(tracing.device_mark(cpu))
    marks.append(tracing.device_mark(cpu))
    first, second = tracing.seconds_between(marks)
    assert all(isinstance(m, float) for m in marks)
    assert first >= 0.002 and 0 <= second < first


def _in_a_thread(fn):
    got = {}
    t = threading.Thread(target=lambda: got.update(rec=fn()))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    return got["rec"]


def _span_in_a_thread(name):
    with tracing.span(name) as rec:
        return rec


def test_a_span_in_another_thread_has_a_stack_of_its_own(monkeypatch):
    with cpu_profile():
        with tracing.span("decode.pass") as main:
            # the profiler follows the thread that started it, and so do the spans
            assert _in_a_thread(lambda: _span_in_a_thread("decode.draft")) is None
            monkeypatch.setattr(tracing, "recording", lambda: True)  # as if it followed
            other = _in_a_thread(lambda: _span_in_a_thread("decode.draft"))
            with tracing.span("decode.verify") as child:
                pass
    assert other.parent is None and other.id != main.id
    assert child.parent == main.id


def _story(n_text, seed):
    """A prompt with one image block and ``n_text`` text tokens ending in
    '<img>', so the forced image chain is drafted from the prompt's chain."""
    cfg = AgentConfig.tiny()
    nq = cfg.num_img_in_tokens
    ids = ([1, 500, BOI_TOKEN_ID] + [FIRST_IMG_TOKEN_ID + j for j in range(nq)] + [EOI_TOKEN_ID]
           + [600 + j for j in range(n_text)] + [BOI_TOKEN_ID])
    cmp_ = np.zeros(len(ids), bool)
    cmp_[3:3 + nq] = True
    embeds = np.random.RandomState(seed).randn(1, cfg.num_vit_tokens,
                                               cfg.vit_dim).astype(np.float32)
    return dict(input_ids=np.asarray(ids), image_embeds=embeds,
                embeds_cmp_mask=np.ones((1,), bool), ids_cmp_mask=cmp_)


def _randomize_(module):
    """Fills every weight matrix (the modules leave some uninitialized) from
    the seeded torch stream, scaled by its fan-in."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() >= 2:
                p.normal_(0, p[0].numel() ** -0.5)
    return module


def _generator(agent, eos):
    return StoryGenerator(agent, GenerateConfig(
        max_new_tokens=30, num_img_gen_tokens=AgentConfig.tiny().num_img_out_tokens,
        eos_token_id=eos, cache_capacity=256, force_boi_at=12, speculate_k=K,
        return_cache=False))


STORIES = [_story(1, 0), _story(5, 1), _story(3, 2)]


@pytest.fixture(scope="module")
def generator():
    """A tiny int8 agent (weights and cache) with random weights, whose EOS
    is a token that the second story alone generates early: that row ends
    some passes before the others."""
    torch.manual_seed(3)
    agent = _randomize_(ContinuousLVLM(AgentConfig.tiny()).eval())
    quantize_agent_(agent, base=True, kv=True)
    outs = _generator(agent, -1).generate_batch(STORIES)
    text = np.flatnonzero(outs[1]["generate_ids"] < BOI_TOKEN_ID)[0]
    eos = int(outs[1]["generate_ids"][text])
    assert not any(eos in o["generate_ids"] for r, o in enumerate(outs) if r != 1)
    return _generator(agent, eos)


def test_the_decode_loop_spans_and_counters_add_up_and_change_no_id(generator):
    stories = STORIES
    plain = generator.generate_batch(stories)
    assert tracing.records() == []
    with cpu_profile() as prof:
        traced = generator.generate_batch(stories)
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a["generate_ids"], b["generate_ids"])

    passes, c = by_name("decode.pass"), tracing.counters()
    assert passes and all(p.parent is None for p in passes)
    assert 0 < c["decode.accepted"] <= c["decode.drafted"] and c["decode.drafted"] % K == 0
    # every committed token but a row's first (the prefill's pick) is one of a
    # committing row's pass: its first pick, or an accepted draft
    committed = sum(len(o["generate_ids"]) - 1 for o in traced)
    assert committed == c["decode.drafted"] // K + c["decode.accepted"]
    # the EOS row commits in fewer passes than the others
    assert c["decode.drafted"] // K < len(stories) * len(passes)
    ids = {p.id for p in passes}
    for name in ("decode.draft", "decode.verify", "decode.sync", "decode.accept"):
        parts = by_name(name)
        assert len(parts) == len(passes) and {r.parent for r in parts} == ids, name
    # each verify pass writes every layer's new rows once; the prefill's writes are under no pass
    layers = generator.agent.cfg.llm.num_hidden_layers
    verify_ids = {r.id for r in by_name("decode.verify")}
    writes = by_name("llm.kv_write")
    assert sum(w.parent in verify_ids for w in writes) == layers * len(passes)
    assert sum(w.parent is None for w in writes) == layers
    for p in passes:
        kids = [r for r in tracing.records() if r.parent == p.id]
        assert sum(r.host_ms() for r in kids) <= p.host_ms()
    names = {e.name for e in prof.events()}
    assert not [n for n in names if n.startswith(PROGRAM_PREFIXES)]


def test_one_story_decode_drafts_k_a_pass(generator):
    s = _story(2, 4)
    with cpu_profile():
        (out,) = generator.generate_batch([s])
    c = tracing.counters()
    assert c["decode.drafted"] == K * len(by_name("decode.pass"))
    assert len(out["generate_ids"]) - 1 == len(by_name("decode.pass")) + c["decode.accepted"]
