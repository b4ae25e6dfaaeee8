"""Port parity of ``seed_story_torch.decode.generate`` on a tiny agent, in
f32 on the CPU, against the JAX package on the same weights:
``top_p_filter`` exactly; temperature / top-p sampling deterministic per
seed and never outside the nucleus; prompt-lookup speculation giving the
port's own plain greedy tokens and the JAX ``_spec_loop``'s tokens (with
and without ``force_boi_at``, float and int8 agent), features within 1e-3;
``generate(cache=...)`` threading the cache."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_story_torch import weights as W
from seed_story_torch.decode import generate as port_gen
from seed_story_torch.inference.common import quantize_agent_
from seed_story_torch.models.agent import AgentConfig, ContinuousLVLM
from seed_story_tpu.data.tokenizer import BOI_TOKEN_ID, EOI_TOKEN_ID, FIRST_IMG_TOKEN_ID
from seed_story_tpu.decode import generate as ref_gen
from seed_story_tpu.models import agent as ref_agent
from seed_story_tpu.models.llama import quantize_llama_params
from test_torch_weights import agent_init_args, jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models run thousands of small ops: one intra-op thread keeps
    them from oversubscribing the cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

MAX_NEW = 24


def _story_inputs(jcfg):
    """A prompt with one image block that ends with '<img>', so the forced
    image chain opens the output and is drafted from the prompt's chain."""
    nq = jcfg.num_img_in_tokens
    prompt = ([1, 500, 501, BOI_TOKEN_ID] + [FIRST_IMG_TOKEN_ID + i for i in range(nq)]
              + [EOI_TOKEN_ID, 600, BOI_TOKEN_ID])
    ids_cmp = np.zeros(len(prompt), bool)
    ids_cmp[4:4 + nq] = True
    embeds = np.random.RandomState(0).randn(1, jcfg.num_vit_tokens,
                                            jcfg.vit_dim).astype(np.float32)
    return np.asarray(prompt), embeds, np.ones((1,), bool), ids_cmp


def _agents(quantized=False):
    """The JAX tiny agent's params and the port's agent on the same weights
    (with ``quantized``: the int8 tree, and the port quantized in place)."""
    jcfg = ref_agent.AgentConfig.tiny()
    jagent = ref_agent.ContinuousLVLM(jcfg)
    params = jax_params(jagent, seed=2, **agent_init_args(jcfg))
    agent = ContinuousLVLM(AgentConfig.tiny())
    agent.load_state_dict(W.agent_state_dict(agent, params))
    agent.eval()
    if quantized:
        params = dict(params, llm=quantize_llama_params(params["llm"]))
        jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, quantize_base=True))
        jagent = ref_agent.ContinuousLVLM(jcfg)
        quantize_agent_(agent, base=True, kv=False)
    return jcfg, jagent, params, agent


def _gen_kw(jcfg, **kw):
    return dict(max_new_tokens=MAX_NEW, num_img_gen_tokens=jcfg.num_img_out_tokens,
                cache_capacity=256, **kw)


def test_top_p_filter_matches_jax_exactly():
    rng = np.random.RandomState(1)
    logits = (rng.randn(4, 300) * rng.choice([0.5, 2.0, 8.0], size=(4, 1))).astype(np.float32)
    logits[0, :3] = [5.0, 5.0, 5.0]  # ties at the top
    for top_p in (0.1, 0.5, 0.9, 0.999):
        want = np.asarray(ref_gen.top_p_filter(jnp.asarray(logits), top_p))
        got = port_gen.top_p_filter(torch.from_numpy(logits), top_p).numpy()
        np.testing.assert_array_equal(got, want)


def test_sampling_is_seeded_and_stays_in_the_nucleus():
    _, _, _, agent = _agents()
    jcfg = ref_agent.AgentConfig.tiny()
    gen = port_gen.StoryGenerator(agent, port_gen.GenerateConfig(
        **_gen_kw(jcfg, temperature=0.9, top_p=0.9)))
    inputs = _story_inputs(jcfg)
    a1 = gen.generate(*inputs, seed=7)["generate_ids"]
    a2 = gen.generate(*inputs, seed=7)["generate_ids"]
    b1 = gen.generate(*inputs, seed=8)["generate_ids"]
    np.testing.assert_array_equal(a1, a2)
    assert not np.array_equal(a1, b1)
    chain = [FIRST_IMG_TOKEN_ID + i for i in range(jcfg.num_img_out_tokens)] + [EOI_TOKEN_ID]
    assert list(a1[:len(chain)]) == chain == list(b1[:len(chain)])

    # draws at fixed logits: every token inside the nucleus, all of it reached
    logits = torch.from_numpy(np.log(np.asarray([[0.5, 0.3, 0.15, 0.05]], np.float32)))
    small = port_gen.StoryGenerator.__new__(port_gen.StoryGenerator)
    small.cfg = port_gen.GenerateConfig(temperature=1.0, top_p=0.75)
    small.automaton = lambda prev, scores: scores
    sampler = (torch.Generator(), 3)
    draws = {int(small._pick(torch.zeros(1, dtype=torch.long), logits, step, sampler))
             for step in range(200)}
    assert draws == {0, 1}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("force_boi_at", [None, 12])
def test_speculation_matches_greedy_and_jax(quantized, force_boi_at):
    jcfg, jagent, params, agent = _agents(quantized)
    inputs = _story_inputs(jcfg)
    jgen = ref_gen.StoryGenerator(jagent, params, ref_gen.GenerateConfig(
        **_gen_kw(jcfg, prompt_bucket=16, force_boi_at=force_boi_at, speculate_k=4,
                  return_cache=False)))
    want = jgen.generate(*inputs)
    outs = {k: port_gen.StoryGenerator(agent, port_gen.GenerateConfig(
        **_gen_kw(jcfg, force_boi_at=force_boi_at, speculate_k=k, return_cache=False))
    ).generate(*inputs) for k in (0, 4)}
    for got in outs.values():
        assert got["num_generated"] == want["num_generated"]
        np.testing.assert_array_equal(got["generate_ids"], want["generate_ids"])
        assert got["has_img_output"] == want["has_img_output"] is True
        np.testing.assert_allclose(got["img_gen_feat"].numpy(),
                                   np.asarray(want["img_gen_feat"]), rtol=0, atol=1e-3)


def test_generate_threads_the_cache_like_jax():
    """A prompt, then a suffix appended to the returned cache: the same
    tokens and cache lengths as the JAX generator, features within 1e-3."""
    jcfg, jagent, params, agent = _agents()
    prompt, embeds, emask, ids_cmp = _story_inputs(jcfg)
    suffix = prompt[3:]  # '<img>' + the image block + text + '<img>'
    jgen = ref_gen.StoryGenerator(jagent, params, ref_gen.GenerateConfig(
        **_gen_kw(jcfg, prompt_bucket=16)))
    gen = port_gen.StoryGenerator(agent, port_gen.GenerateConfig(**_gen_kw(jcfg)))
    w1 = jgen.generate(prompt, embeds, emask, ids_cmp)
    g1 = gen.generate(prompt, embeds, emask, ids_cmp)
    assert g1["cache"].capacity == 256 and g1["cache"].length == [len(prompt) + MAX_NEW - 1]
    w2 = jgen.generate(suffix, embeds, emask, ids_cmp[3:], cache=w1["cache"])
    g2 = gen.generate(suffix, embeds, emask, ids_cmp[3:], cache=g1["cache"])
    assert g2["cache"].length == [int(w2["cache"].length[0])]
    for w, g in ((w1, g1), (w2, g2)):
        np.testing.assert_array_equal(g["generate_ids"], w["generate_ids"])
        np.testing.assert_allclose(g["img_gen_feat"].numpy(), np.asarray(w["img_gen_feat"]),
                                   rtol=0, atol=1e-3)


def test_quantize_agent_keeps_a_configured_int8_cache():
    """``quantize_agent_`` only switches the flags on: an agent whose LLaMA
    configuration asks for an int8 cache keeps it when only the weights are
    quantized, as the JAX cache follows the LLaMA configuration's own flag."""
    cfg = AgentConfig.tiny()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, quantize_kv=True))
    agent = W.init_random_(ContinuousLVLM(cfg), seed=4).eval()
    quantize_agent_(agent, base=True, kv=False)
    assert agent.cfg.llm.quantize_kv and agent.cfg.llm.quantize_base
    assert agent.llm.cfg.quantize_kv and agent.llm.model.cfg.quantize_kv
    jcfg = ref_agent.AgentConfig.tiny()
    gen = port_gen.StoryGenerator(agent, port_gen.GenerateConfig(
        max_new_tokens=2, num_img_gen_tokens=jcfg.num_img_out_tokens, cache_capacity=64))
    cache = gen.generate(*_story_inputs(jcfg))["cache"]
    assert cache.quantized and cache.k[0].dtype == torch.int8


def test_speculate_k_above_7_is_refused():
    with pytest.raises(ValueError, match="speculate_k"):
        port_gen.GenerateConfig(speculate_k=8)
