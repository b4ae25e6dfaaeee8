"""Port parity of the IP adapters (``seed_story_torch/models/ipa_adapters.py``,
``IPAResampler``) and their SD sampling pipeline
(``seed_story_torch/pipelines/ipa_pipeline.py``), in f32 on the CPU on the
JAX tests' tiny SD-1.5-layout configs (``tests/test_ipa_adapters.py``),
against the JAX package on the same weights (carried by
``seed_story_torch.weights``) and the same numpy-seeded inputs.

Tolerances: module outputs and ``noise_pred`` 1e-5 of their largest entry;
losses 1e-5 absolute; gradients 1e-4 of the JAX gradient's largest entry,
per parameter; the trainable mask leaf for leaf; the pipeline's uint8
images within 1/255 of the JAX pipeline's, its initial latents the JAX
draw fed in.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from seed_story_torch import weights as W
from seed_story_torch.models import ipa_adapters as port
from seed_story_torch.models.ipa_resampler import IPAResampler
from seed_story_torch.models.sdxl.unet import SDXLUNetConfig
from seed_story_torch.models.sdxl.vae import AutoencoderKL, VAEConfig
from seed_story_torch.pipelines import ipa_pipeline as port_pipe
from seed_story_tpu.models import ipa_adapters as ref
from seed_story_tpu.models import ipa_resampler as ref_resampler
from seed_story_tpu.models.sdxl import schedulers as ref_sched
from seed_story_tpu.models.sdxl import unet as ref_unet
from seed_story_tpu.models.sdxl import vae as ref_vae
from seed_story_tpu.pipelines import ipa_pipeline as ref_pipe
from test_torch_weights import jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REL_TOL, LOSS_TOL, GRAD_REL_TOL = 1e-5, 1e-5, 1e-4
# the JAX tests' tiny SD-1.5 layout: a cross-attention block, then a plain one
SD15 = dict(block_out_channels=(16, 32), down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
            transformer_layers_per_block=(1, 1), attention_head_dim=8, cross_attention_dim=24,
            addition_embed_type=None, norm_num_groups=8)
IPA = dict(image_embedding_dim=48, num_image_tokens=4, resampler_depth=1)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _flat(tree):
    return traverse_util.flatten_dict(nn.meta.unbox(tree), sep="/")


def _assert_rel(got, want, rel=REL_TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def _unets(**kw):
    return (ref_unet.SDXLUNetConfig(**SD15, dtype=jnp.float32, **kw),
            SDXLUNetConfig(**SD15, dtype=torch.float32, **kw))


def test_ipa_resampler_matches_jax():
    kw = dict(dim=24, depth=2, num_queries=4, embedding_dim=40, output_dim=32, heads=2,
              dim_head=8)
    x = _randn(0, 2, 7, 40)
    jm = ref_resampler.IPAResampler(**kw)
    params = jax_params(jm, jnp.asarray(x), seed=1)
    m = IPAResampler(**kw)
    m.load_state_dict(W.ipa_adapter_state_dict(m, params))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.shape == (2, 4, 32)
    _assert_rel(got.numpy(), jm.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("scale", [0.0, 1.0])
def test_ip_cross_attention_matches_jax(scale):
    """Text K/V on 5 keys and image K/V on 3: the JAX output at both scales;
    at scale 0 the image tokens change nothing."""
    kw = dict(query_dim=32, heads=2, dim_head=16, text_context_len=5, scale=scale)
    x, ctx = _randn(0, 1, 7, 32), _randn(1, 1, 8, 32)
    jm = ref.IPCrossAttention(**kw)
    params = jax_params(jm, jnp.asarray(x), jnp.asarray(ctx), seed=2)
    m = port.IPCrossAttention(**kw)
    m.load_state_dict(W.ipa_adapter_state_dict(m, params))
    ctx2 = ctx.copy()
    ctx2[:, 5:] = 123.0
    with torch.no_grad():
        out, out2 = (m(torch.from_numpy(x), torch.from_numpy(c)).numpy() for c in (ctx, ctx2))
    _assert_rel(out, jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx)))
    _assert_rel(out2, jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx2)))
    if scale == 0.0:
        np.testing.assert_array_equal(out, out2)
    else:
        assert np.abs(out - out2).max() > 1e-3


@pytest.fixture(scope="module")
def ip_adapters():
    """The JAX IPAdapterSD on the JAX test's tiny config, its parameters,
    and the port's on the same weights."""
    jcfg_unet, cfg_unet = _unets()
    jm = ref.IPAdapterSD(ref.IPAdapterConfig(unet=jcfg_unet, **IPA))
    params = jax_params(jm, noisy_latents=jnp.zeros((1, 8, 8, 4)), timesteps=jnp.array([5]),
                        text_embeds=jnp.zeros((1, 7, 24)), image_embeds=jnp.zeros((1, 10, 48)),
                        noise=jnp.zeros((1, 8, 8, 4)), seed=3)
    assert "add_embedding" not in params["unet"]
    m = port.IPAdapterSD(port.IPAdapterConfig(unet=cfg_unet, **IPA))
    m.load_state_dict(W.ipa_adapter_state_dict(m, params))
    return jm, params, m


def test_ip_adapter_loss_and_gradients_match_jax(ip_adapters):
    jm, params, m = ip_adapters
    inputs = (_randn(4, 2, 8, 8, 4), np.array([5, 700], np.int32), _randn(5, 2, 7, 24),
              _randn(6, 2, 10, 48), _randn(7, 2, 8, 8, 4))
    (want, wout), jgrads = jax.jit(jax.value_and_grad(
        lambda p, *a: (lambda o: (o["total_loss"], o))(jm.apply({"params": p}, *a)),
        has_aux=True))(params, *map(jnp.asarray, inputs))
    out = m(*map(torch.from_numpy, inputs))
    out["total_loss"].backward()
    np.testing.assert_allclose(float(out["total_loss"].detach()), float(want), rtol=0,
                               atol=LOSS_TOL)
    _assert_rel(out["noise_pred"].detach().numpy(), wout["noise_pred"])
    flat = _flat(jgrads)
    for name, (path, transform) in W.ipa_adapter_flax_paths(m).items():
        _assert_rel(m.get_parameter(name).grad.numpy(), transform(np.asarray(flat[path])),
                    GRAD_REL_TOL, name)
    m.zero_grad(set_to_none=True)


def test_latent_image_adapter_matches_jax():
    jcfg = ref.EditAdapterConfig(unet=ref_unet.SDXLUNetConfig(
        in_channels=8, block_out_channels=(16, 32, 32), transformer_layers_per_block=(1, 1, 1),
        attention_head_dim=8, cross_attention_dim=32, addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=8 * 6 + 64, pooled_projection_dim=64,
        norm_num_groups=8, dtype=jnp.float32))
    jm = ref.SDXLAdapterWithLatentImage(jcfg)
    inputs = (_randn(0, 2, 8, 8, 4), _randn(1, 2, 8, 8, 4), np.array([3, 400], np.int32),
              _randn(2, 2, 6, 32), _randn(3, 2, 64),
              np.array([[8, 8, 0, 0, 8, 8], [16, 8, 4, 0, 8, 8]], np.float32),
              _randn(4, 2, 8, 8, 4))
    params = jax_params(jm, *map(jnp.asarray, inputs), seed=5)
    cfg = port.EditAdapterConfig(unet=SDXLUNetConfig(**{
        f.name: getattr(jcfg.unet, f.name) for f in dataclasses.fields(SDXLUNetConfig)
        if f.name not in ("dtype", "param_dtype", "quantize")}, dtype=torch.float32))
    m = port.SDXLAdapterWithLatentImage(cfg)
    m.load_state_dict(W.adapter_state_dict(m, params))
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = m(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(float(got["total_loss"]), float(want["total_loss"]), rtol=0,
                               atol=LOSS_TOL)
    _assert_rel(got["noise_pred"].numpy(), want["noise_pred"])


def _sd21_pair():
    jcfg_unet, cfg_unet = _unets(in_channels=8)
    rkw = dict(dim=24, depth=1, num_queries=4, embedding_dim=40, output_dim=24)
    jm = ref.SD21Text2ImageAndEditAdapter(ref.SD21EditAdapterConfig(unet=jcfg_unet),
                                          resampler=ref_resampler.IPAResampler(**rkw))
    inputs = (_randn(0, 2, 8, 8, 8), np.array([5, 900], np.int32), np.zeros((2, 3, 16), np.float32),
              _randn(1, 2, 7, 40), _randn(2, 2, 8, 8, 4))
    params = jax_params(jm, *map(jnp.asarray, inputs), seed=6)
    m = port.SD21Text2ImageAndEditAdapter(port.SD21EditAdapterConfig(unet=cfg_unet),
                                          resampler=IPAResampler(**rkw))
    m.load_state_dict(W.adapter_state_dict(m, params))
    return jm, jcfg_unet, params, m, inputs


def test_sd21_edit_adapter_loss_and_trainable_mask_match_jax():
    jm, jcfg_unet, params, m, inputs = _sd21_pair()
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = m(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(float(got["total_loss"]), float(want["total_loss"]), rtol=0,
                               atol=LOSS_TOL)
    _assert_rel(got["noise_pred"].numpy(), want["noise_pred"])

    jmask = _flat(ref.sd21_edit_trainable_mask(params, jcfg_unet))
    mask = port.sd21_edit_trainable_mask(m)
    assert list(mask) == [name for name, _ in m.named_parameters()]
    paths = W.adapter_flax_paths(m)
    assert sorted(paths[name][0] for name in mask) == sorted(jmask)
    for name, trains in mask.items():
        assert trains == bool(jmask[paths[name][0]]), name
    assert mask["unet.conv_in.weight"] and mask["resampler.latents"]
    assert mask["unet.down_blocks.1.resnets.0.conv1.weight"]
    assert not mask["unet.down_blocks.0.resnets.0.conv1.weight"]
    assert not any(v for k, v in mask.items() if ".to_k." in k or ".to_v." in k)


def test_sd21_default_config_is_the_sd21_layout():
    cfg = port.SD21EditAdapterConfig().unet
    jcfg = ref.SD21EditAdapterConfig().unet
    for field in ("in_channels", "block_out_channels", "down_block_types", "up_block_types",
                  "transformer_layers_per_block", "cross_attention_dim", "addition_embed_type",
                  "attention_head_dim", "layers_per_block"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    ipa, jipa = port.IPAdapterConfig(), ref.IPAdapterConfig()
    assert ipa.unet.cross_attention_dim == jipa.unet.cross_attention_dim == 768
    assert (ipa.image_embedding_dim, ipa.num_image_tokens, ipa.resampler_depth) == (
        jipa.image_embedding_dim, jipa.num_image_tokens, jipa.resampler_depth)


def test_ip_adapter_pipeline_matches_jax_with_its_latents(ip_adapters):
    """The JAX test's pipeline (zero-image negatives, injected text and
    visual encoders, scale 0.8 and 0, 2 Euler steps, the tiny VAE) with the
    JAX draw of the initial latents fed to the port."""
    jm, params, m = ip_adapters
    jvae = ref_vae.AutoencoderKL(ref_vae.VAEConfig(block_out_channels=(16, 32), norm_num_groups=8,
                                                   dtype=jnp.float32))
    vae_params = jax_params(jvae, jnp.zeros((1, 16, 16, 3)), seed=7)
    vae = AutoencoderKL(VAEConfig.tiny())
    vae.load_state_dict(W.vae_state_dict(vae, vae_params))

    def visual_encode(pixels):
        # stand-in frozen encoder: deterministic features from pixel statistics
        rng = np.random.RandomState(int(abs(np.asarray(pixels).mean()) * 100) % 97)
        return rng.randn(pixels.shape[0], 10, 48).astype(np.float32)

    def encode_text(prompts):
        rng = np.random.RandomState(len("".join(prompts)) % 97)
        return rng.randn(len(prompts), 7, 24).astype(np.float32)

    sample = dict(height=16, width=16, num_inference_steps=2, vae_scale=2)
    jpipe = ref_pipe.IPAdapterSDPipeline(jm, params, jvae, vae_params, encode_text, visual_encode,
                                         cfg=ref_pipe.IPASampleConfig(**sample))
    pipe = port_pipe.IPAdapterSDPipeline(m, vae.eval(), encode_text,
                                         lambda t: visual_encode(t.numpy()),
                                         cfg=port_pipe.IPASampleConfig(**sample))
    img_in = _randn(0, 1, 3, 16, 16)
    _, sigmas = ref_sched.EulerDiscreteScheduler(ref_sched.SchedulerConfig()).timesteps_and_sigmas(2)
    init = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 8, 8, 4), jnp.float32)
                      * ref_sched.EulerDiscreteScheduler.init_noise_sigma(sigmas))
    images = {}
    for scale in (0.8, 0.0):
        want = jpipe.generate(img_in, prompt="a dog", scale=scale, seed=3)
        got = pipe.generate(torch.from_numpy(img_in), prompt="a dog", scale=scale,
                            init_latents=init)
        assert got.shape == (1, 16, 16, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, scale
        images[scale] = got
    assert np.abs(images[0.8].astype(int) - images[0.0].astype(int)).max() > 0
    # with no latents given, the seeded generator draws them: same seed, same image
    a, b = (pipe.generate(torch.from_numpy(img_in), prompt="a dog", scale=0.8, seed=5)
            for _ in range(2))
    np.testing.assert_array_equal(a, b)
