"""Port parity on the vision side and the agent's image paths, in f32 on
the CPU, on weights carried from the JAX modules by
``seed_story_torch.weights``: the ViT with attention pool, the Qwen
``Resampler``, ``scatter_image_embeds`` / ``gather_image_hidden``,
``embed_with_images``, ``resample_output`` and the image-token automaton."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_story_torch import weights as W
from seed_story_torch.decode.logits_processors import ImageTokenAutomaton
from seed_story_torch.models import agent as port_agent
from seed_story_torch.models.resampler import Resampler
from seed_story_torch.models.vit import VisionTransformerWithAttnPool, ViTConfig
from seed_story_tpu.decode.logits_processors import ImageTokenAutomaton as RefAutomaton
from seed_story_tpu.models import agent as ref_agent
from seed_story_tpu.models import vit as ref_vit
from seed_story_tpu.models.resampler import Resampler as RefResampler
from test_torch_weights import agent_init_args, jax_params

# Matmuls and convolutions in full f32 on every backend, so the tolerances hold.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def test_vit_with_attn_pool_matches_jax():
    jcfg = ref_vit.ViTConfig.tiny(dtype=jnp.float32)
    pixels = np.random.RandomState(0).randn(2, 3, 56, 56).astype(np.float32)
    jvit = ref_vit.VisionTransformerWithAttnPool(jcfg)
    params = jax_params(jvit, jnp.asarray(pixels))
    want = jvit.apply({"params": params}, jnp.asarray(pixels))

    vit = VisionTransformerWithAttnPool(ViTConfig.tiny(dtype=torch.float32)).eval()
    vit.load_state_dict(W.vit_state_dict(vit, params))
    with torch.no_grad():
        got = vit(torch.from_numpy(pixels))
    assert got.shape == (2, 16, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("grid,kv_dim,kv_len", [(3, 48, 16), (2, None, 9), (4, 40, 16)])
def test_qwen_resampler_matches_jax(grid, kv_dim, kv_len):
    x = np.random.RandomState(grid).randn(2, kv_len, kv_dim or 64).astype(np.float32)
    jres = RefResampler(grid_size=grid, embed_dim=64, num_heads=4, kv_dim=kv_dim)
    params = jax_params(jres, jnp.asarray(x), seed=1)
    want = jres.apply({"params": params}, jnp.asarray(x))

    res = Resampler(grid_size=grid, embed_dim=64, num_heads=4, kv_dim=kv_dim).eval()
    res.load_state_dict(W.agent_state_dict(res, params))
    with torch.no_grad():
        got = res(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _agent_pair(seed=7):
    jcfg = ref_agent.AgentConfig.tiny()
    jagent = ref_agent.ContinuousLVLM(jcfg)
    params = jax_params(jagent, seed=seed, **agent_init_args(jcfg))
    agent = port_agent.ContinuousLVLM(port_agent.AgentConfig.tiny()).eval()
    agent.load_state_dict(W.agent_state_dict(agent, params))
    return jagent, params, agent


def test_embed_with_images_and_resample_output_match_jax():
    jagent, params, agent = _agent_pair()
    rng = np.random.RandomState(3)
    ids = rng.randint(100, 32000, size=(2, 20))
    ids_mask = np.zeros((2, 20), bool)
    ids_mask[0, 2:6] = ids_mask[1, 5:9] = True  # two selected images x 4 tokens
    emask = np.array([True, False, True])
    images = rng.randn(3, 9, 128).astype(np.float32)
    want = jagent.apply({"params": params}, jnp.asarray(ids), jnp.asarray(images),
                        jnp.asarray(ids_mask), jnp.asarray(emask),
                        method=jagent.embed_with_images)
    hidden = rng.randn(2, 9, 128).astype(np.float32)
    want_feats = jagent.apply({"params": params}, jnp.asarray(hidden),
                              method=jagent.resample_output)
    with torch.no_grad():
        got = agent.embed_with_images(torch.from_numpy(ids), torch.from_numpy(images),
                                      torch.from_numpy(ids_mask), torch.from_numpy(emask))
        feats = agent.resample_output(torch.from_numpy(hidden))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), rtol=0, atol=1e-5)


def test_scatter_and_gather_row_order_match_jax():
    rng = np.random.RandomState(5)
    embeds = rng.randn(2, 12, 8).astype(np.float32)
    images = rng.randn(4, 3, 8).astype(np.float32)
    ids_mask = np.zeros((2, 12), bool)
    ids_mask[0, 1:4] = ids_mask[0, 7:10] = ids_mask[1, 4:7] = True
    emask = np.array([False, True, True, True])
    got = port_agent.scatter_image_embeds(torch.from_numpy(embeds), torch.from_numpy(images),
                                          torch.from_numpy(ids_mask), torch.from_numpy(emask))
    want = ref_agent.scatter_image_embeds(jnp.asarray(embeds), jnp.asarray(images),
                                          jnp.asarray(ids_mask), jnp.asarray(emask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = port_agent.gather_image_hidden(torch.from_numpy(embeds), torch.from_numpy(ids_mask),
                                         torch.from_numpy(emask), 3)
    want = ref_agent.gather_image_hidden(jnp.asarray(embeds), jnp.asarray(ids_mask),
                                         jnp.asarray(emask), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_image_token_automaton_matches_jax():
    rng = np.random.RandomState(6)
    vocab = 32128
    prev = np.array([1, 32000, 32002, 32065, 32001, 500])  # bos, <img>, img_0, img_63, </img>, word
    scores = rng.randn(len(prev), vocab).astype(np.float32)
    got = ImageTokenAutomaton(vocab)(torch.from_numpy(prev), torch.from_numpy(scores))
    want = RefAutomaton(vocab)(jnp.asarray(prev), jnp.asarray(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
