"""Port parity of the remaining model variants, in f32 on the CPU on tiny
configs, against the JAX package on the same weights (carried by
``seed_story_torch.weights``) and the same numpy-seeded inputs: the no-pool
ViT (``VisionTransformer``), ``ResamplerXL`` and ``ResamplerXLIdentity``,
and the align-only agent ``SEEDLLaMAAlignGeneration`` (its loss, its
output resampler's gradients, ``align_trainable_mask``, and greedy stories
from the port's ``decode/generate.py`` against the JAX ``StoryGenerator``).

Tolerances: ViT features and resampler outputs 1e-4 / 1e-5 of their largest
entry; the align loss 1e-5 absolute; gradients 1e-4 of the JAX gradient's
largest entry, per parameter; greedy tokens identical, image features 1e-3.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from seed_story_torch import weights as W
from seed_story_torch.decode import generate as port_gen
from seed_story_torch.models import agent as port_agent
from seed_story_torch.models.ipa_resampler import ResamplerXL, ResamplerXLIdentity
from seed_story_torch.models.llama import LlamaConfig
from seed_story_torch.models.vit import VisionTransformer, VisionTransformerWithAttnPool, ViTConfig
from seed_story_tpu.data.tokenizer import BOI_TOKEN_ID
from seed_story_tpu.decode import generate as ref_gen
from seed_story_tpu.models import agent as ref_agent
from seed_story_tpu.models import ipa_resampler as ref_resampler
from seed_story_tpu.models import llama as ref_llama
from seed_story_tpu.models import vit as ref_vit
from test_torch_train import tiny_batch
from test_torch_weights import agent_init_args, jax_params

torch.backends.cuda.matmul.allow_tf32 = False

LOSS_TOL, GRAD_REL_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return traverse_util.flatten_dict(nn.meta.unbox(tree), sep="/")


def _assert_rel(got, want, rel, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def test_no_pool_vit_matches_jax_and_loads_the_pool_vits_weights():
    pixels = np.random.RandomState(0).randn(2, 3, 56, 56).astype(np.float32)
    jvit = ref_vit.VisionTransformer(ref_vit.ViTConfig.tiny(dtype=jnp.float32))
    params = jax_params(jvit, jnp.asarray(pixels), seed=1)
    vit = VisionTransformer(ViTConfig.tiny(dtype=torch.float32))
    vit.load_state_dict(W.vit_state_dict(vit, params))
    with torch.no_grad():
        got = vit(torch.from_numpy(pixels))
    assert got.shape == (2, 16, 64)
    _assert_rel(got.numpy(), jvit.apply({"params": params}, jnp.asarray(pixels)), 1e-4)

    # the pool ViT's state dict loads with strict=False, its pool tensors left out
    pool = W.init_random_(VisionTransformerWithAttnPool(ViTConfig.tiny(dtype=torch.float32)), 2)
    missing, unexpected = vit.load_state_dict(pool.state_dict(), strict=False)
    assert missing == [] and unexpected and all(
        k.startswith(("attn_pool.", "ln_post.", "proj")) for k in unexpected)
    with torch.no_grad():
        np.testing.assert_array_equal(vit(torch.from_numpy(pixels)).numpy(),
                                      VisionTransformer.forward(pool, torch.from_numpy(pixels)))


def test_resampler_xl_and_identity_match_jax():
    kw = dict(dim=32, depth=1, heads=2, num_queries=4, embedding_dim=40, output1_dim=16,
              output2_dim=24)
    x = np.random.RandomState(3).randn(2, 9, 40).astype(np.float32)
    jm = ref_resampler.ResamplerXL(**kw)
    params = jax_params(jm, jnp.asarray(x), seed=4)
    m = ResamplerXL(**kw)
    m.load_state_dict(W.ipa_adapter_state_dict(m, params))
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    for g, w in zip(got, want):
        _assert_rel(g.numpy(), w, 1e-5)
    # V1 skips the token-axis L2 normalization: a scaled input changes the output
    with torch.no_grad():
        assert not torch.allclose(m(2 * torch.from_numpy(x))[0], got[0])
    pooled = torch.ones(2, 24)
    out = ResamplerXLIdentity()(torch.from_numpy(x), pooled)
    jout = ref_resampler.ResamplerXLIdentity().apply({}, jnp.asarray(x), jnp.ones((2, 24)))
    assert out[1] is pooled
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))


@pytest.fixture(scope="module")
def align_pair():
    llm = dict(dtype=jnp.float32, lora_rank=4, lora_dropout=0.0)
    jcfg = ref_agent.AgentConfig.tiny(llm=ref_llama.LlamaConfig.tiny(**llm))
    jagent = ref_agent.SEEDLLaMAAlignGeneration(jcfg)

    def loss_and_logits(m, **kw):
        # the loss never calls lm_head, which generation needs: init both
        return m(**kw), m.llm(inputs_embeds=m.embed_tokens(kw["input_ids"]))

    params = jax_params(jagent, seed=11, method=loss_and_logits, **agent_init_args(jcfg))
    llm["dtype"] = torch.float32
    agent = port_agent.SEEDLLaMAAlignGeneration(
        port_agent.AgentConfig.tiny(llm=LlamaConfig.tiny(**llm)))
    agent.load_state_dict(W.agent_state_dict(agent, params))
    return jcfg, jagent, params, agent


def test_align_loss_and_resampler_gradients_match_jax(align_pair):
    jcfg, jagent, params, agent = align_pair
    batch = tiny_batch(seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, wout), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o["total_loss"], o))(jagent.apply({"params": p}, **jbatch)),
        has_aux=True))(params)
    mask = port_agent.align_trainable_mask(agent)
    for name, p in agent.named_parameters():
        p.requires_grad_(mask[name])
    out = agent(**{k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    out["total_loss"].backward()
    np.testing.assert_allclose(float(out["total_loss"].detach()), float(want), rtol=0,
                               atol=LOSS_TOL)
    assert float(out["rec_loss"].detach()) == float(out["total_loss"].detach())
    _assert_rel(out["recon_image_embeds"].detach().numpy(), wout["recon_image_embeds"], 1e-5)
    flat = _flat(jgrads)
    paths = W.agent_flax_paths(agent)
    for name, p in agent.named_parameters():
        want_g = np.asarray(paths[name][1](np.asarray(flat[paths[name][0]])))
        if mask[name]:
            _assert_rel(p.grad.numpy(), want_g, GRAD_REL_TOL, name)
            p.grad = None
        else:  # stop_gradient: the LLM gets none, in JAX a zero gradient
            assert p.grad is None and not want_g.any(), name
        p.requires_grad_(True)


def test_align_trainable_mask_is_the_output_resampler_leaf_for_leaf(align_pair):
    _, _, params, agent = align_pair
    jmask = _flat(ref_agent.align_trainable_mask(params))
    mask = port_agent.align_trainable_mask(agent)
    paths = W.agent_flax_paths(agent)
    assert list(mask) == [name for name, _ in agent.named_parameters()]
    assert sorted(paths[name][0] for name in mask) == sorted(jmask)
    for name, trains in mask.items():
        assert trains == bool(jmask[paths[name][0]]), name
    assert any(mask.values()) and not any(v for k, v in mask.items() if k.startswith("llm."))


def test_greedy_story_of_the_align_agent_matches_the_jax_generator(align_pair):
    """A text-seeded story (the images are ignored) with the forced image
    chain: the port's generator drives the align agent unchanged."""
    jcfg, jagent, params, agent = align_pair
    prompt = np.asarray([1, 500, 501, 502, 600, 601, BOI_TOKEN_ID])
    embeds = np.random.RandomState(0).randn(1, jcfg.num_vit_tokens, jcfg.vit_dim).astype(
        np.float32)
    args = (prompt, embeds, np.zeros((1,), bool), np.zeros(len(prompt), bool))
    kw = dict(max_new_tokens=24, num_img_gen_tokens=jcfg.num_img_out_tokens, cache_capacity=128,
              force_boi_at=12, return_cache=False)
    want = ref_gen.StoryGenerator(jagent, params, ref_gen.GenerateConfig(
        prompt_bucket=16, **kw)).generate(*args)
    agent.eval()
    got = port_gen.StoryGenerator(agent, port_gen.GenerateConfig(**kw)).generate(*args)
    assert got["num_generated"] == want["num_generated"]
    np.testing.assert_array_equal(got["generate_ids"], want["generate_ids"])
    assert got["has_img_output"] == want["has_img_output"] is True
    np.testing.assert_allclose(got["img_gen_feat"].numpy(), np.asarray(want["img_gen_feat"]),
                               rtol=0, atol=1e-3)
