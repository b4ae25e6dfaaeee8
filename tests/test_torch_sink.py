"""Port parity of the sink-cache flows, in f32 on the CPU, against the JAX
package: ``_compact`` carrying the int8 scales with the tokens; the
retained-token sets of ``SinkKVCacheManager`` (the reference policy and the
``max_sink`` cap); a tiny ``run_sink`` story (story_len 10, window 4) and a
tiny visualization story on the same weights: texts identical, features
within 1e-3; and ``run_sink`` with ``speculate_k=4`` giving the plain
``run_sink`` story."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_story_torch.data.tokenizer import TinyTokenizer
from seed_story_torch.decode import sink_cache as port_sink
from seed_story_torch.decode.generate import GenerateConfig, StoryGenerator
from seed_story_torch.models.llama import KVCache, LlamaConfig
from seed_story_torch.pipelines import story_generation as port_story
from seed_story_torch.pipelines import story_visualization as port_vis
from seed_story_tpu.data.tokenizer import TinyTokenizer as RefTokenizer
from seed_story_tpu.decode import generate as ref_gen
from seed_story_tpu.decode import sink_cache as ref_sink
from seed_story_tpu.models import llama as ref_llama
from seed_story_tpu.pipelines import story_generation as ref_story
from seed_story_tpu.pipelines import story_visualization as ref_vis
from test_torch_generate import _agents

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


def _position_coded(capacity: int, live_len: int, quantized: bool):
    """Port and JAX caches whose K/V (and scales) at slot j hold j (+ 0.5 for
    the scales), so the retained slots can be read back."""
    cfg = LlamaConfig.tiny()
    cache = KVCache.create(cfg, 1, capacity, dtype=torch.float32, quantized=quantized)
    pos = torch.arange(capacity)
    for i in range(cfg.num_hidden_layers):
        for buf in (cache.k[i], cache.v[i]):
            buf.copy_((pos % 128)[None, None, :, None].expand_as(buf).to(buf.dtype))
        if quantized:
            cache.k_scale[i].copy_((pos + 0.5).float()[None, None].expand_as(cache.k_scale[i]))
            cache.v_scale[i].copy_((pos + 0.25).float()[None, None].expand_as(cache.v_scale[i]))
    cache.length = [live_len]
    arrays = lambda bufs: tuple(jnp.asarray(b.numpy()) for b in bufs)  # noqa: E731
    jcache = ref_llama.KVCache(
        k=arrays(cache.k), v=arrays(cache.v), length=jnp.asarray([live_len], jnp.int32),
        k_scale=arrays(cache.k_scale) if quantized else None,
        v_scale=arrays(cache.v_scale) if quantized else None)
    return cache, jcache


def _assert_same_cache(cache, jcache, n):
    assert cache.length == [int(jcache.length[0])]
    pairs = [(cache.k, jcache.k), (cache.v, jcache.v)]
    if cache.quantized:
        pairs += [(cache.k_scale, jcache.k_scale), (cache.v_scale, jcache.v_scale)]
    for got, want in pairs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy()[:, :, :n], np.asarray(w)[:, :, :n])


def test_compact_carries_the_scales_with_the_tokens():
    cache, jcache = _position_coded(48, 40, quantized=True)
    keep = [0, 1] + list(range(6, 40))
    idx = np.asarray(keep + [0] * (48 - len(keep)))
    cache = port_sink._compact(cache, torch.from_numpy(idx), len(keep))
    jcache = ref_sink._compact(jcache, jnp.asarray(idx, jnp.int32), jnp.int32(len(keep)))
    assert cache.quantized and cache.capacity == 48
    assert float(cache.k_scale[0][0, 0, 2]) == 6.5 and int(cache.k[1][0, 0, 2, 0]) == 6
    _assert_same_cache(cache, jcache, len(keep))


@pytest.mark.parametrize("max_sink", [None, 40])
def test_retained_sets_match_jax(max_sink):
    """Three evictions (the first-4 block, the windows, the duplicated tail
    overlap; with the cap the oldest windows drop)."""
    cache, jcache = _position_coded(128, 100, quantized=max_sink is not None)
    mgr = port_sink.SinkKVCacheManager(capacity=128, max_sink=max_sink)
    jmgr = ref_sink.SinkKVCacheManager(capacity=128, max_sink=max_sink)
    live = 100
    for boi, eoi in ((20, 30), (12, 22), (2, 14)):
        cache, dropped = mgr.evict_image_span(cache, boi, eoi, live)
        jcache, jdropped = jmgr.evict_image_span(jcache, boi, eoi, live)
        assert dropped == jdropped == eoi + 1
        assert mgr.sink_len == jmgr.sink_len
        _assert_same_cache(cache, jcache, cache.length[0])
        live -= dropped
    if max_sink is not None:
        assert mgr.sink_len <= max_sink
        assert [int(x) for x in cache.k[0][0, 0, :4, 0]] == [0, 1, 2, 3]
    cache = mgr.truncate(cache, 50)
    assert cache.length == [int(jmgr.truncate(jcache, 50).length[0])] == [50]


def _story_setup(speculate_k=0):
    jcfg, jagent, params, agent = _agents()
    kw = dict(max_new_tokens=24, num_img_gen_tokens=jcfg.num_img_out_tokens,
              cache_capacity=1024, prompt_bucket=64, force_boi_at=8, return_cache=True)
    jgen = ref_gen.StoryGenerator(jagent, params, ref_gen.GenerateConfig(**kw))
    gen = StoryGenerator(agent, GenerateConfig(speculate_k=speculate_k, **kw))
    feats = np.random.RandomState(3).randn(1, jcfg.num_vit_tokens,
                                           jcfg.vit_dim).astype(np.float32)
    return jcfg, jgen, gen, (lambda px: feats), (lambda px: torch.from_numpy(feats))


def _assert_same_story(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.index, g.text, g.context_tokens) == (w.index, w.text, w.context_tokens)
        assert (g.image_features is None) == (w.image_features is None)
        if w.image_features is not None:
            np.testing.assert_allclose(g.image_features.numpy(), np.asarray(w.image_features),
                                       rtol=0, atol=1e-3)


def test_run_sink_matches_jax():
    jcfg, jgen, gen, jencode, encode = _story_setup()
    story = dict(story_len=10, window_size=4, num_img_in_tokens=jcfg.num_img_in_tokens)
    start = np.zeros((1, 3, 8, 8), np.float32)
    want = list(ref_story.StoryGenerationPipeline(
        RefTokenizer(), jgen, jencode, None, ref_story.StoryPipelineConfig(**story)
    ).run_sink(start, "a long story"))
    got = list(port_story.StoryGenerationPipeline(
        TinyTokenizer(), gen, encode, None, port_story.StoryPipelineConfig(**story)
    ).run_sink(start, "a long story"))
    assert len(got) == 9  # 5 evictions past the window of 4
    _assert_same_story(got, want)
    late = [s.context_tokens for s in got[-4:]]
    assert all(0 <= b - a <= 28 for a, b in zip(late, late[1:])), late


def test_run_sink_speculative_matches_plain():
    jcfg, _, plain_gen, _, encode = _story_setup()
    spec_gen = _story_setup(speculate_k=4)[2]
    story = port_story.StoryPipelineConfig(story_len=10, window_size=4,
                                           num_img_in_tokens=jcfg.num_img_in_tokens)
    start = np.zeros((1, 3, 8, 8), np.float32)
    plain = list(port_story.StoryGenerationPipeline(
        TinyTokenizer(), plain_gen, encode, None, story).run_sink(start, "a long story"))
    spec = list(port_story.StoryGenerationPipeline(
        TinyTokenizer(), spec_gen, encode, None, story).run_sink(start, "a long story"))
    assert [s.text for s in spec] == [s.text for s in plain]
    for a, b in zip(plain, spec):
        torch.testing.assert_close(b.image_features, a.image_features, rtol=0, atol=1e-3)


def test_visualization_matches_jax():
    jcfg, jgen, gen, jencode, encode = _story_setup()
    vis = dict(story_len=8, window_size=3, num_img_in_tokens=jcfg.num_img_in_tokens)
    texts = [f"scene {i} of the story" for i in range(10)]
    start = np.zeros((1, 3, 8, 8), np.float32)
    want = list(ref_vis.StoryVisualizationPipeline(
        RefTokenizer(), jgen, jencode, None, ref_vis.VisPipelineConfig(**vis)
    ).run(start, "once upon a time", texts))
    got = list(port_vis.StoryVisualizationPipeline(
        TinyTokenizer(), gen, encode, None, port_vis.VisPipelineConfig(**vis)
    ).run(start, "once upon a time", texts))
    assert len(got) == 7  # evictions past the window of 3
    _assert_same_story(got, want)
