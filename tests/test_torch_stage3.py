"""Port parity of stage 3 (the de-tokenizer adaptation), in f32 on the CPU
on tiny configs, against the JAX package on the same weights (carried by
``seed_story_torch.weights``) and the same numpy-seeded inputs: the VAE
encoder, ``DDPMScheduler``, ``select_gen_embeds``, the adapter's training
forward, trainable set and gradients, the whole stage-3 loss with its
frozen ViT, agent and VAE, and trainer steps.

Tolerances: VAE latents 1e-5 of the largest |latent|, pixels after encode
and decode 1e-4 of the largest |pixel|; ``add_noise`` bitwise (f32 and
bf16); losses 1e-5; ``noise_pred`` 1e-5 of its largest entry; gradients
1e-4 of the largest entry of the JAX gradient, per parameter; parameters
after 1 and 3 trainer steps 1e-5 max abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_story_torch import weights as W
from seed_story_torch.models.sdxl import schedulers as port_sched
from seed_story_torch.models.sdxl.adapter import (
    SDXLAdapter,
    SDXLAdapterConfig,
    adapter_trainable_mask,
)
from seed_story_torch.models.sdxl.unet import SDXLUNetConfig
from seed_story_torch.models.sdxl.vae import AutoencoderKL, VAEConfig
from seed_story_torch.models.vit import VisionTransformerWithAttnPool, ViTConfig
from seed_story_torch.train.stage3 import make_stage3_loss_fn, select_gen_embeds
from seed_story_torch.train.trainer import TrainConfig, Trainer
from seed_story_tpu.models.sdxl import adapter as ref_adapter
from seed_story_tpu.models.sdxl import schedulers as ref_sched
from seed_story_tpu.models.sdxl import unet as ref_unet
from seed_story_tpu.models.sdxl import vae as ref_vae
from seed_story_tpu.models import vit as ref_vit
from seed_story_tpu.parallel.mesh import make_mesh
from seed_story_tpu.train import stage3 as ref_stage3
from seed_story_tpu.train import trainer as ref_trainer
from test_torch_train import TRAIN, _agent_pair, _flat, _torch_batch, tiny_batch
from test_torch_weights import adapter_init_args, jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LAT, PIX = 8, 16  # tiny UNet latent side; the tiny VAE downsamples 2x
# the tiny UNet with one resnet a block and one transformer block an
# attention, which keeps the JAX traces and compiles of the stage short
UNET = dict(layers_per_block=1, transformer_layers_per_block=(1, 1, 1))
LOSS_TOL, GRAD_REL_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test, so parallel workers do not oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vaes():
    jvae = ref_vae.AutoencoderKL(ref_vae.VAEConfig.tiny())
    params = jax_params(jvae, jnp.zeros((1, PIX, PIX, 3)), seed=3)
    vae = AutoencoderKL(VAEConfig.tiny()).eval().requires_grad_(False)
    vae.load_state_dict(W.vae_state_dict(vae, params))
    return jvae, params, vae


def _jax_adapter():
    return ref_adapter.SDXLAdapter(ref_adapter.SDXLAdapterConfig.tiny(
        unet=ref_unet.SDXLUNetConfig.tiny(**UNET)))


@pytest.fixture(scope="module")
def adapters():
    jadapter = _jax_adapter()
    return jadapter, jax_params(jadapter, seed=2, **adapter_init_args(LAT))


def _port_adapter(params):
    adapter = SDXLAdapter(SDXLAdapterConfig.tiny(unet=SDXLUNetConfig.tiny(**UNET)))
    adapter.load_state_dict(W.adapter_state_dict(adapter, params))
    return adapter


def _sd_inputs(seed=0, b=2):
    rng = np.random.RandomState(seed)
    pixels = rng.uniform(-1.0, 1.0, size=(b, 3, PIX, PIX)).astype(np.float32)
    time_ids = np.array([[PIX, PIX, 0, 0, PIX, PIX], [20, PIX, 2, 0, PIX, PIX]][:b], np.int32)
    return pixels, time_ids


def _assert_rel(got, want, rel, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()), err_msg=name)


def test_vae_encode_matches_jax(vaes):
    jvae, params, vae = vaes
    pixels = np.transpose(_sd_inputs()[0], (0, 2, 3, 1))
    rng = jax.random.PRNGKey(5)

    @jax.jit
    def jax_side(x):
        apply = lambda *a, **k: jvae.apply({"params": params}, x, *a, **k)  # noqa: E731
        # encode's mode, its sample from rng, and __call__ (encode, then decode)
        return apply(method=jvae.encode), apply(rng=rng, method=jvae.encode), apply(rng)

    want_mode, want_sample, want_pixels = jax_side(jnp.asarray(pixels))
    eps = np.array(jax.random.normal(rng, want_mode.shape))  # the draw encode makes
    x = torch.from_numpy(pixels)
    with torch.no_grad():
        mode = vae.encode(x)
        sample = vae.encode(x, eps=torch.from_numpy(eps))
        decoded = vae.decode(sample)
    assert vae.latent_shape(x.shape) == tuple(mode.shape) == (2, LAT, LAT, 4)
    _assert_rel(mode.numpy(), want_mode, 1e-5)
    _assert_rel(sample.numpy(), want_sample, 1e-5)
    assert not np.allclose(mode.numpy(), sample.numpy())
    _assert_rel(decoded.numpy(), want_pixels, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddpm_add_noise_is_bitwise_the_jax_function(dtype):
    rng = np.random.RandomState(0)
    sample = rng.randn(4, LAT, LAT, 4).astype(np.float32)
    noise = rng.randn(4, LAT, LAT, 4).astype(np.float32)
    t = np.array([0, 1, 500, 999], np.int32)
    want = ref_sched.DDPMScheduler().add_noise(
        jnp.asarray(sample, getattr(jnp, dtype)), jnp.asarray(noise), jnp.asarray(t))
    got = port_sched.DDPMScheduler().add_noise(
        torch.from_numpy(sample).to(getattr(torch, dtype)), torch.from_numpy(noise),
        torch.from_numpy(t))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_ddpm_timesteps_are_seeded_int32_in_range():
    sch = port_sched.DDPMScheduler()
    np.testing.assert_array_equal(sch.alphas_cumprod.numpy(),
                                  np.asarray(ref_sched.DDPMScheduler().alphas_cumprod))
    t = sch.sample_timesteps(4096, torch.Generator().manual_seed(3))
    assert t.dtype == torch.int32 and t.shape == (4096,)
    assert int(t.min()) == 0 and int(t.max()) == 999  # [0, 1000): both ends drawn
    assert torch.equal(t, sch.sample_timesteps(4096, torch.Generator().manual_seed(3)))


def test_select_gen_embeds_matches_jax():
    recon = np.random.RandomState(1).randn(3 * 4, 5, 6).astype(np.float32)
    mask = np.zeros(12, bool)
    mask[2] = True  # sample 0: its third image
    mask[11] = True  # sample 2: its last; sample 1 has none and takes its first
    want = ref_stage3.select_gen_embeds(jnp.asarray(recon), jnp.asarray(mask), 3)
    got = select_gen_embeds(torch.from_numpy(recon), torch.from_numpy(mask), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), recon[[2, 4, 11]])


@pytest.mark.parametrize("full_ft", [False, True])
def test_trainable_set_maps_one_to_one_onto_the_jax_mask(adapters, full_ft):
    _, params = adapters
    want = {p for p, m in _flat(ref_adapter.adapter_trainable_mask(params, full_ft)).items()
            if m}
    adapter = _port_adapter(params)
    mask = adapter_trainable_mask(adapter, full_ft)
    assert list(mask) == [name for name, _ in adapter.named_parameters()]
    paths = W.adapter_flax_paths(adapter)
    got = [paths[name][0] for name, m in mask.items() if m]
    assert len(set(got)) == len(got) and set(got) == want
    for part in ("attn1/to_k/kernel", "attn2/to_v/kernel", "resampler/latents"):
        assert any(p.endswith(part) for p in got), part
    assert any(p.endswith("attn1/to_q/kernel") for p in got) == full_ft


def _adapter_inputs(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, LAT, LAT, 4).astype(np.float32), np.array([901, 41], np.int32),
            rng.randn(2, 9, 128).astype(np.float32),
            np.array([[64, 64, 0, 0, 64, 64], [48, 64, 8, 0, 64, 64]], np.float32),
            rng.randn(2, LAT, LAT, 4).astype(np.float32))


def _assert_grads_match(model, jgrads, paths):
    """Each trainable parameter's gradient against the JAX one, 1e-4 of the
    JAX gradient's largest entry; frozen parameters get none. The attention
    pool's key bias adds one constant to each query's scores, which the
    softmax cancels: its exact gradient is 0, and both packages give f32
    noise there, held to 1e-4 of the largest gradient entry of the model."""
    flat = _flat(jgrads)
    largest = max(float(np.abs(np.asarray(flat[paths[name][0]])).max())
                  for name, p in model.named_parameters() if p.requires_grad)
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        path, transform = paths[name]
        want = np.asarray(transform(np.asarray(flat[path])))
        if name.endswith("unet_attnpool.k_proj.bias"):
            assert float(np.abs(p.grad.numpy()).max()) <= GRAD_REL_TOL * largest, name
            assert float(np.abs(want).max()) <= GRAD_REL_TOL * largest, name
        else:
            _assert_rel(p.grad.numpy(), want, GRAD_REL_TOL, name)


def test_adapter_training_forward_matches_jax(adapters):
    jadapter, params = adapters
    inputs = _adapter_inputs()
    want = jax.jit(lambda p, *a: jadapter.apply({"params": p}, *a))(
        params, *map(jnp.asarray, inputs))
    with torch.no_grad():
        out = _port_adapter(params)(*map(torch.from_numpy, inputs))
    assert out["total_loss"].dtype == torch.float32 and out["total_loss"].shape == ()
    np.testing.assert_allclose(float(out["total_loss"]), float(want["total_loss"]), rtol=0,
                               atol=LOSS_TOL)
    _assert_rel(out["noise_pred"].numpy(), want["noise_pred"], 1e-5)


def _stage3_pair(seed=3, with_vit=True):
    """The JAX and port stage-3 loss functions on one set of tiny weights:
    (jax loss_fn, its frozen consts, adapter params, port loss_fn, adapter).
    Without the ViT the batch carries ``image_embeds``."""
    jagent, agent_params, agent = _agent_pair(seed=seed)
    agent.eval().requires_grad_(False)
    consts = {"agent_params": agent_params}
    jvit = vit = None
    if with_vit:
        jvit = ref_vit.VisionTransformerWithAttnPool(
            ref_vit.ViTConfig.tiny(dtype=jnp.float32, n_queries=9))
        consts["vit_params"] = jax_params(jvit, jnp.zeros((1, 3, 56, 56)), seed=seed + 1)
        vit = VisionTransformerWithAttnPool(ViTConfig.tiny(dtype=torch.float32, n_queries=9))
        vit.load_state_dict(W.vit_state_dict(vit, consts["vit_params"]))
        vit.eval().requires_grad_(False)
    jvae = ref_vae.AutoencoderKL(ref_vae.VAEConfig.tiny())
    consts["vae_params"] = jax_params(jvae, jnp.zeros((1, PIX, PIX, 3)), seed=seed + 2)
    vae = AutoencoderKL(VAEConfig.tiny())
    vae.load_state_dict(W.vae_state_dict(vae, consts["vae_params"]))
    vae.eval().requires_grad_(False)
    jadapter = _jax_adapter()
    adapter_params = jax_params(jadapter, seed=seed + 3, **adapter_init_args(LAT))
    adapter = _port_adapter(adapter_params)

    def jax_draw(seed, latent_shape, device):
        """The three draws the JAX loss makes from its step rng."""
        rng_noise, rng_t, rng_vae = jax.random.split(jax.random.PRNGKey(seed), 3)
        draws = (jax.random.normal(rng_noise, latent_shape, jnp.float32),
                 ref_sched.DDPMScheduler().sample_timesteps(rng_t, latent_shape[0]),
                 jax.random.normal(rng_vae, latent_shape))
        return tuple(torch.from_numpy(np.array(x)).to(device) for x in draws)

    return (ref_stage3.make_stage3_loss_fn(jadapter, jagent, jvae, jvit), consts,
            adapter_params, make_stage3_loss_fn(adapter, agent, vae, vit, draw=jax_draw),
            adapter)


def stage3_batch(seed=0, with_vit=True):
    """A stage-2 tiny batch (with the ViT's pixels in place of its
    features), the SDXL targets and their time_ids."""
    batch = tiny_batch(seed=seed)
    if with_vit:
        batch.pop("image_embeds")
        batch["images"] = np.random.RandomState(seed + 100).randn(4, 3, 56, 56).astype(
            np.float32)
    batch["sd_images"], batch["time_ids"] = _sd_inputs(seed + 200)
    return batch


def test_stage3_loss_and_trainable_gradients_match_jax():
    """The loss and, through the UNet and the resampler, the gradient of
    every trainable parameter against ``jax.grad``; frozen parameters of the
    adapter get none."""
    jloss_fn, consts, params, loss_fn, adapter = _stage3_pair()
    batch = stage3_batch()
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jloss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(11), consts), has_aux=True))(params)

    for name, m in adapter_trainable_mask(adapter).items():
        adapter.get_parameter(name).requires_grad_(m)
    loss, metrics = loss_fn(_torch_batch(batch), 11)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=0, atol=LOSS_TOL)
    assert float(metrics["mse_loss"]) == float(loss)
    _assert_grads_match(adapter, jgrads, W.adapter_flax_paths(adapter))


def test_trainer_steps_match_the_jax_trainer():
    """Three steps of two accumulated microbatches, on ViT features (the ViT
    is held above); parameters after the first and the third."""
    jloss_fn, consts, params, loss_fn, adapter = _stage3_pair(seed=5, with_vit=False)
    batches = [stage3_batch(seed=s, with_vit=False) for s in range(2)]
    batch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jcfg = ref_trainer.TrainConfig(sharding_preset="dp", grad_accum_steps=2, **TRAIN)
    mesh = make_mesh(data=1, model=1)
    jtrainer = ref_trainer.Trainer(mesh, jax.eval_shape(lambda: params), jloss_fn, jcfg,
                                   trainable_mask=ref_adapter.adapter_trainable_mask(params),
                                   loss_consts=consts)
    trainer = Trainer(adapter, loss_fn, TrainConfig(grad_accum_steps=2, **TRAIN),
                      trainable_mask=adapter_trainable_mask(adapter))
    jbatch, tbatch = {k: jnp.asarray(v) for k, v in batch.items()}, _torch_batch(batch)
    paths = W.adapter_flax_paths(adapter)
    with mesh:
        state = jtrainer.init_state(jax.tree_util.tree_map(jnp.array, params))
        # the step counter as the step returns it, so the step compiles once
        state.step = jax.device_put(state.step, jtrainer.replicated)
        for step in range(3):
            state, jm = jtrainer.step(state, jbatch, jax.random.PRNGKey(step))
            m = trainer.step(tbatch, step)
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=0, atol=LOSS_TOL)
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
            if step in (0, 2):
                flat = _flat(state.params)
                for name, (path, transform) in paths.items():
                    np.testing.assert_allclose(
                        adapter.get_parameter(name).detach().numpy(),
                        transform(np.asarray(flat[path])), rtol=0, atol=PARAM_TOL,
                        err_msg=f"step {step + 1}: {name}")
    assert trainer.step_count == int(state.step) == 3
