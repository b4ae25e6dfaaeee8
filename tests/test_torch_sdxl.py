"""Port parity on the de-tokenizer side, in f32 on the CPU, on weights
carried from the JAX modules by ``seed_story_torch.weights``:
ResamplerXLV2 (its token-axis L2 normalize included), the Euler timesteps
and sigmas, the UNet ``denoise``, the VAE decode, and
``SDXLImagePipeline.generate`` started from JAX's own initial noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_story_torch import weights as W
from seed_story_torch.models.sdxl import schedulers as port_sched
from seed_story_torch.models.sdxl.adapter import SDXLAdapter, SDXLAdapterConfig
from seed_story_torch.models.sdxl.vae import AutoencoderKL, VAEConfig
from seed_story_torch.pipelines.sdxl_pipeline import SDXLImagePipeline, SDXLSampleConfig
from seed_story_tpu.models.sdxl import adapter as ref_adapter
from seed_story_tpu.models.sdxl import schedulers as ref_sched
from seed_story_tpu.models.sdxl import vae as ref_vae
from seed_story_tpu.pipelines import sdxl_pipeline as ref_pipe
from test_torch_weights import adapter_init_args, jax_params

# Matmuls and convolutions in full f32 on every backend, so the tolerances hold.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LAT = 8  # tiny UNet latent side; the tiny VAE upsamples 2x


@pytest.fixture(scope="module")
def adapters():
    jadapter = ref_adapter.SDXLAdapter(ref_adapter.SDXLAdapterConfig.tiny())
    params = jax_params(jadapter, seed=2, **adapter_init_args(LAT))
    adapter = SDXLAdapter(SDXLAdapterConfig.tiny()).eval()
    adapter.load_state_dict(W.adapter_state_dict(adapter, params))
    return jadapter, params, adapter


@pytest.fixture(scope="module")
def vaes():
    jvae = ref_vae.AutoencoderKL(ref_vae.VAEConfig.tiny())
    params = jax_params(jvae, jnp.zeros((1, 8, 8, 3)), seed=3)
    vae = AutoencoderKL(VAEConfig.tiny()).eval()
    vae.load_state_dict(W.vae_state_dict(vae, params))
    return jvae, params, vae


def test_resampler_xlv2_matches_jax(adapters):
    jadapter, params, adapter = adapters
    # feature scales differ per token, so the token-axis normalize matters
    x = (np.random.RandomState(0).randn(2, 9, 128)
         * np.arange(1, 10)[None, :, None]).astype(np.float32)
    want_prompt, want_pooled = jadapter.apply({"params": params}, jnp.asarray(x),
                                              method=jadapter.encode_image_embeds)
    with torch.no_grad():
        prompt, pooled = adapter.encode_image_embeds(torch.from_numpy(x))
    np.testing.assert_allclose(prompt.numpy(), np.asarray(want_prompt), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), rtol=0, atol=1e-4)


@pytest.mark.parametrize("steps", [3, 8, 50])
def test_euler_timesteps_and_sigmas_match_jax(steps):
    ts, sig = port_sched.EulerDiscreteScheduler().timesteps_and_sigmas(steps)
    want_ts, want_sig = ref_sched.EulerDiscreteScheduler().timesteps_and_sigmas(steps)
    np.testing.assert_array_equal(ts, want_ts)
    np.testing.assert_array_equal(sig, want_sig)
    assert (port_sched.EulerDiscreteScheduler.init_noise_sigma(sig)
            == ref_sched.EulerDiscreteScheduler.init_noise_sigma(want_sig))


def test_unet_denoise_matches_jax(adapters):
    jadapter, params, adapter = adapters
    rng = np.random.RandomState(1)
    lat = rng.randn(2, LAT, LAT, 4).astype(np.float32)
    t = np.array([901.0, 41.0], np.float32)
    prompt = rng.randn(2, 8, 96).astype(np.float32)
    pooled = rng.randn(2, 64).astype(np.float32)
    time_ids = np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (2, 1))
    denoise = jax.jit(lambda p, *a: jadapter.apply({"params": p}, *a, method=jadapter.denoise))
    want = denoise(params, *map(jnp.asarray, (lat, t, prompt, pooled, time_ids)))
    with torch.no_grad():
        got = adapter.denoise(*map(torch.from_numpy, (lat, t, prompt, pooled, time_ids)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_vae_decode_matches_jax(vaes):
    jvae, params, vae = vaes
    lat = np.random.RandomState(2).randn(1, 6, 6, 4).astype(np.float32)
    want = jvae.apply({"params": params}, jnp.asarray(lat), method=jvae.decode)
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(lat))
    assert got.shape == (1, 12, 12, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_sampling_pipeline_matches_jax(adapters, vaes):
    jadapter, aparams, adapter = adapters
    jvae, vparams, vae = vaes
    cfg = dict(height=16, width=16, num_inference_steps=3, vae_scale=2)
    rng = np.random.RandomState(4)
    feats = rng.randn(1, 9, 128).astype(np.float32)
    neg = rng.randn(1, 9, 128).astype(np.float32)
    seed = 42
    jpipe = ref_pipe.SDXLImagePipeline(jadapter, aparams, jvae, vparams,
                                       cfg=ref_pipe.SDXLSampleConfig(**cfg))
    jpipe._build()
    time_ids = np.array([[16, 16, 0, 0, 16, 16]], np.float32)
    want = np.asarray(jpipe._jitted(aparams, vparams, jnp.asarray(feats), jnp.asarray(neg),
                                    jnp.asarray(time_ids), jax.random.PRNGKey(seed)))
    # the JAX pipeline's own initial noise, handed to the port
    _, sigmas = ref_sched.EulerDiscreteScheduler().timesteps_and_sigmas(3)
    init = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, 8, 8, 4), jnp.float32)
                      * ref_sched.EulerDiscreteScheduler.init_noise_sigma(sigmas))

    pipe = SDXLImagePipeline(adapter, vae, cfg=SDXLSampleConfig(**cfg))
    pixels = pipe.generate_pixels(feats, neg, init_latents=init)
    np.testing.assert_allclose(pixels.numpy(), want, rtol=0, atol=1e-3)
    images = pipe.generate(feats, neg, init_latents=init)
    assert images.shape == (1, 16, 16, 3) and images.dtype == np.uint8
