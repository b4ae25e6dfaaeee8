"""Port parity of the lockstep batch on a tiny agent, in f32 on the CPU,
against the JAX package on the same weights: the cached forward with
per-row ``seq_lengths`` (a ragged (B, P) block), ``generate_batch`` (plain
greedy, speculative, the int8 agent with an int8 cache, and three stories
of unequal prompt lengths and image counts whose rows end at different
steps), the port's batch rows against its own one-story ``generate``, and
``StoryGenerationPipeline.run_batch`` with window eviction and a story
that ends without an image. Tokens and texts must be identical, logits
within 1e-5 of max |logit|, image features within 1e-3."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_story_torch import weights as W
from seed_story_torch.decode import generate as port_gen
from seed_story_torch.inference.common import quantize_agent_
from seed_story_torch.models.agent import AgentConfig, ContinuousLVLM
from seed_story_torch.models.llama import KVCache
from seed_story_torch.pipelines import story_generation as port_story
from seed_story_tpu.data.tokenizer import (BOI_TOKEN_ID, EOI_TOKEN_ID, FIRST_IMG_TOKEN_ID,
                                           TinyTokenizer)
from seed_story_tpu.decode import generate as ref_gen
from seed_story_tpu.models import agent as ref_agent
from seed_story_tpu.models import llama as ref_llama
from seed_story_tpu.models.llama import quantize_llama_params
from seed_story_tpu.pipelines import story_generation as ref_story
from test_torch_weights import agent_init_args, jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MAX_NEW = 24


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def agents():
    """{False: float, True: int8 weights and cache}: the JAX agent, its
    params and the port's agent on the same weights."""
    jcfg = ref_agent.AgentConfig.tiny()
    params = jax_params(ref_agent.ContinuousLVLM(jcfg), seed=2, **agent_init_args(jcfg))
    out = {}
    for quantized in (False, True):
        agent = ContinuousLVLM(AgentConfig.tiny())
        agent.load_state_dict(W.agent_state_dict(agent, params))
        agent.eval()
        cfg, p = jcfg, params
        if quantized:
            p = dict(params, llm=quantize_llama_params(params["llm"]))
            cfg = dataclasses.replace(jcfg, llm=dataclasses.replace(
                jcfg.llm, quantize_base=True, quantize_kv=True))
            quantize_agent_(agent, base=True, kv=True)
        out[quantized] = (cfg, ref_agent.ContinuousLVLM(cfg), p, agent)
    return out


def _story(jcfg, n_images: int, text, trailing_boi: bool, seed: int):
    """A prompt of ``n_images`` comprehension blocks and ``text`` tokens
    (ending with '<img>' when ``trailing_boi``), with its image features."""
    nq = jcfg.num_img_in_tokens
    ids, cmp_ = [1], []
    for i in range(n_images):
        ids += [500 + i, BOI_TOKEN_ID]
        cmp_.append(len(ids))
        ids += [FIRST_IMG_TOKEN_ID + j for j in range(nq)] + [EOI_TOKEN_ID]
    ids += list(text) + ([BOI_TOKEN_ID] if trailing_boi else [])
    ids_cmp = np.zeros(len(ids), bool)
    for at in cmp_:
        ids_cmp[at:at + nq] = True
    embeds = np.random.RandomState(seed).randn(n_images, jcfg.num_vit_tokens,
                                               jcfg.vit_dim).astype(np.float32)
    return dict(input_ids=np.asarray(ids), image_embeds=embeds,
                embeds_cmp_mask=np.ones((n_images,), bool), ids_cmp_mask=ids_cmp)


def _stories(jcfg, ragged3: bool):
    if ragged3:
        return [_story(jcfg, 1, [600, 601], True, 0), _story(jcfg, 2, [610], False, 1),
                _story(jcfg, 1, [620, 621, 622, 623, 624, 625], False, 2)]
    return [_story(jcfg, 1, [600], True, 0), _story(jcfg, 1, [700, 701], False, 3)]


def _gen_kw(jcfg, **kw):
    return dict(max_new_tokens=MAX_NEW, num_img_gen_tokens=jcfg.num_img_out_tokens,
                cache_capacity=256, return_cache=False, **kw)


def _port_gen(agent, jcfg, **kw):
    return port_gen.StoryGenerator(agent, port_gen.GenerateConfig(**_gen_kw(jcfg, **kw)))


def _eos_for_row(agent, jcfg, stories, row: int, at: int, **kw) -> int:
    """A token that row ``row`` generates at step ``at`` (EOS banned) and no
    other row generates before its step ``at`` + 4: as EOS it ends that row
    early while the others decode on."""
    outs = _port_gen(agent, jcfg, eos_token_id=-1, **kw).generate_batch(stories)
    tok = int(outs[row]["generate_ids"][at])
    assert not any(tok in o["generate_ids"][:at + 4] for r, o in enumerate(outs) if r != row)
    return tok


def _assert_same(got, want, atol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["num_generated"] == w["num_generated"]
        np.testing.assert_array_equal(g["generate_ids"], w["generate_ids"])
        assert g["has_img_output"] == w["has_img_output"]
        if w["has_img_output"]:
            np.testing.assert_allclose(g["img_gen_feat"].numpy(), np.asarray(w["img_gen_feat"]),
                                       rtol=0, atol=atol)


def test_ragged_prefill_matches_jax_seq_lengths(agents):
    """Two right-padded blocks of unequal per-row lengths (B = 3; the second
    starts at unequal cache lengths), then a one-token step that must not
    see the padding's K/V: the logits at each row's last true position
    within 1e-5 of max |logit|, and the same cache lengths."""
    jcfg, jagent, params, agent = agents[False]
    llm = jcfg.llm
    rng = np.random.RandomState(5)
    jcache = ref_llama.KVCache.create(llm, 3, 64, dtype=jnp.float32)
    cache = KVCache.create(agent.cfg.llm, 3, 64, dtype=torch.float32)

    def step(embeds, lens):
        last = np.asarray(lens) - 1
        out = jagent.apply({"params": params}, jnp.asarray(embeds), jcache,
                           seq_lengths=jnp.asarray(lens, jnp.int32),
                           logits_indices=jnp.asarray(last), method=jagent.llm_step)
        with torch.no_grad():
            got = agent.llm_step(torch.from_numpy(embeds), cache, seq_lengths=lens,
                                 logits_indices=torch.from_numpy(last))
        want = np.asarray(out["logits"])[..., :llm.vocab_size]
        np.testing.assert_allclose(got["logits"].numpy()[..., :llm.vocab_size], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        return out["cache"]

    for lens in ([11, 4, 7], [3, 9, 1], [1, 1, 1]):
        embeds = (rng.randn(3, max(lens), llm.hidden_size) * 0.5).astype(np.float32)
        jcache = step(embeds, lens)
        assert cache.length == np.asarray(jcache.length).tolist()
    assert cache.length == [15, 14, 9]


@pytest.mark.parametrize("config", ["plain", "speculative", "int8", "ragged3"])
def test_generate_batch_matches_jax(agents, config):
    """Identical tokens and counts, features within 1e-3. ``ragged3``: three
    stories with 1, 2 and 1 images and prompts of unequal length, one of
    which ends at an early EOS (its row then rides the passes frozen),
    under speculation."""
    jcfg, jagent, params, agent = agents[config == "int8"]
    stories = _stories(jcfg, config == "ragged3")
    kw = dict(force_boi_at=12)
    if config != "plain":
        kw["speculate_k"] = 4
    if config == "ragged3":
        kw["eos_token_id"] = _eos_for_row(agent, jcfg, stories, row=1, at=5, **kw)
    jgen = ref_gen.StoryGenerator(jagent, params, ref_gen.GenerateConfig(
        **_gen_kw(jcfg, prompt_bucket=16, max_context_images=2, **kw)))
    want = jgen.generate_batch(stories)
    got = _port_gen(agent, jcfg, **kw).generate_batch(stories)
    _assert_same(got, want, atol=1e-3)
    if config == "ragged3":
        assert got[1]["num_generated"] == 6 and got[0]["num_generated"] == MAX_NEW


@pytest.mark.parametrize("speculate_k", [0, 3, 4])
def test_generate_batch_rows_match_their_own_generate(agents, speculate_k):
    """Each row of the lockstep batch equals that story run alone (plain
    greedy and speculation), with rows ending at different steps."""
    jcfg, _, _, agent = agents[False]
    stories = _stories(jcfg, ragged3=True)
    kw = dict(force_boi_at=12, speculate_k=speculate_k)
    kw["eos_token_id"] = _eos_for_row(agent, jcfg, stories, row=1, at=5, **kw)
    gen = _port_gen(agent, jcfg, **kw)
    alone = [gen.generate(s["input_ids"], s["image_embeds"], s["embeds_cmp_mask"],
                          s["ids_cmp_mask"]) for s in stories]
    got = gen.generate_batch(stories)
    _assert_same(got, [{k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                        for k, v in a.items()} for a in alone], atol=1e-5)
    assert len({g["num_generated"] for g in got}) > 1


def test_generate_batch_refuses_a_cache_keeping_generator(agents):
    jcfg, _, _, agent = agents[False]
    gen = port_gen.StoryGenerator(agent, port_gen.GenerateConfig(
        **dict(_gen_kw(jcfg), return_cache=True)))
    with pytest.raises(ValueError, match="return_cache=False"):
        gen.generate_batch(_stories(jcfg, ragged3=False))


def _visual_encode(jcfg):
    def encode(pixels):
        rng = np.random.RandomState(int(abs(float(np.asarray(pixels).mean())) * 100) % 1000)
        return rng.randn(1, jcfg.num_vit_tokens, jcfg.vit_dim).astype(np.float32)
    return encode


SEEDS = [(np.full((1, 3, 8, 8), v, np.float32), caption) for v, caption in (
    (0.0, "a brave squirrel found a map"), (0.25, "george visited the museum"),
    (0.5, "george rode the blue train"))]


def test_run_batch_matches_jax(agents):
    """Three stories, story_len 4 and window 2 (the oldest image leaves each
    story's prompt), one ending without an image in its first round: the
    same rounds, the same None layout, identical texts, features within
    1e-3."""
    jcfg, jagent, params, agent = agents[False]
    encode = _visual_encode(jcfg)
    story_kw = dict(story_len=4, window_size=2, num_img_in_tokens=jcfg.num_img_in_tokens)
    kw = dict(force_boi_at=8)
    port_pipe = port_story.StoryGenerationPipeline(
        TinyTokenizer(), _port_gen(agent, jcfg, eos_token_id=-1, **kw),
        lambda px: torch.from_numpy(encode(px)), None,
        port_story.StoryPipelineConfig(**story_kw))
    # EOS: the third token of story 1's first round, which no other story emits there
    first = port_pipe.generator.generate_batch
    probe = []
    port_pipe.generator.generate_batch = lambda b: probe.append(first(b)) or probe[-1]
    next(port_pipe.run_batch(SEEDS))
    eos = int(probe[0][1]["generate_ids"][2])
    assert not any(eos in probe[0][r]["generate_ids"] for r in (0, 2))
    kw["eos_token_id"] = eos

    jgen = ref_gen.StoryGenerator(jagent, params, ref_gen.GenerateConfig(
        **_gen_kw(jcfg, prompt_bucket=128, max_context_images=3, **kw)))
    want = list(ref_story.StoryGenerationPipeline(
        TinyTokenizer(), jgen, encode, None, ref_story.StoryPipelineConfig(**story_kw)
    ).run_batch(SEEDS))
    got = list(port_story.StoryGenerationPipeline(
        TinyTokenizer(), _port_gen(agent, jcfg, **kw), lambda px: torch.from_numpy(encode(px)),
        None, port_story.StoryPipelineConfig(**story_kw)).run_batch(SEEDS))

    assert [[s is None for s in r] for r in got] == [[s is None for s in r] for r in want]
    assert [s is None for s in got[0]] == [True, False, True]  # story 1 ends at once
    assert len(got) >= 3
    for g_round, w_round in zip(got, want):
        for g, w in zip(g_round, w_round):
            if w is None:
                continue
            assert (g.index, g.text, g.context_tokens) == (w.index, w.text, w.context_tokens)
            assert (g.image_features is None) == (w.image_features is None)
            if w.image_features is not None:
                np.testing.assert_allclose(g.image_features.numpy(), w.image_features,
                                           rtol=0, atol=1e-3)
