"""Stage 3 and the SDXL UNet under the port's parallel layer, on the CPU: the
stage-3 draws of a sharded step, ``dp`` / ``fsdp`` / ``fsdp_tp`` stage-3
steps at two ranks against the one-process step on the global batch and
the JAX ``Trainer`` of the same preset, the UNet's Megatron split (a
``model`` = 2 UNet's eps, GEGLU's pairing, the GroupNorm refusal, the
fallback for heads that do not divide ``model``) and a (1, 2) checkpoint
resumed at one rank.

Two ranks run once, as ``torch.multiprocessing`` spawn processes over
``gloo`` (one torch thread a rank); each writes what it computed to a file
and the checks run here, the JAX trainers running while the ranks work.
The tiny adapter of ``test_torch_stage3.py`` (one resnet a block, one
transformer block an attention), f32, on ViT features; inputs from seeded
numpy; the JAX loss's draws fed through ``draw=`` at the global shape.

Tolerances: losses and grad norms 1e-5 relative; parameters 1e-5 relative
to the largest entry of each against the one-process port, 1e-5 absolute
against the JAX trainer (``test_torch_stage3.py``'s ``PARAM_TOL``); the
split UNet's eps 1e-5 of its largest entry; GEGLU's shards 1e-6; the
restored checkpoint bitwise.
"""

import logging
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from seed_story_torch.models.sdxl.adapter import (SDXLAdapter, SDXLAdapterConfig,
                                                  adapter_trainable_mask)
from seed_story_torch.models.sdxl.unet import (FeedForwardGEGLU, ResnetBlock2D, SDXLUNetConfig,
                                               UNet2DConditionModel)
from seed_story_torch.models.sdxl.vae import AutoencoderKL, VAEConfig
from seed_story_torch.parallel import collectives as C
from seed_story_torch.parallel import sharding
from seed_story_torch.parallel.mesh import make_mesh
from seed_story_torch.train.checkpoint import CheckpointManager
from seed_story_torch.train.stage3 import make_stage3_loss_fn
from seed_story_torch.train.trainer import TrainConfig, Trainer

TRAIN = dict(learning_rate=1e-3, warmup_steps=1, training_steps=10, adam_eps=1e-5)
PRESETS = {"dp": (2, 1), "fsdp": (2, 1), "fsdp_tp": (1, 2)}
UNET = dict(layers_per_block=1, transformer_layers_per_block=(1, 1, 1))
STEPS = 2  # the first step has lr 0 under warmup; the second moves the parameters
REL = 1e-5
PER_IMAGE = ("image_embeds", "embeds_cmp_mask", "embeds_gen_mask")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, outdir):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world))
    assert C.initialize_multihost(device="cpu") == (rank, world)
    try:
        torch.save(_ranks_scenario(rank, outdir), os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# -- what the ranks compute ----------------------------------------------------


def _adapter(outdir):
    adapter = SDXLAdapter(SDXLAdapterConfig.tiny(unet=SDXLUNetConfig.tiny(**UNET)))
    adapter.load_state_dict(torch.load(os.path.join(outdir, "adapter.pt"), weights_only=True))
    return adapter


def _frozen(outdir):
    """The frozen agent and VAE, whole on every rank."""
    from seed_story_torch.models import agent as port_agent
    from seed_story_torch.models.llama import LlamaConfig

    agent = port_agent.ContinuousLVLM(port_agent.AgentConfig.tiny(
        llm=LlamaConfig.tiny(dtype=torch.float32, lora_rank=4)))
    agent.load_state_dict(torch.load(os.path.join(outdir, "agent.pt"), weights_only=True))
    vae = AutoencoderKL(VAEConfig.tiny())
    vae.load_state_dict(torch.load(os.path.join(outdir, "vae.pt"), weights_only=True))
    return agent.eval().requires_grad_(False), vae.eval().requires_grad_(False)


def _saved_draw(outdir):
    """The JAX loss's draws for each step's seed, at the global shape."""
    draws = torch.load(os.path.join(outdir, "draws.pt"), weights_only=True)

    def draw(seed, latent_shape, device):
        saved = draws[seed]
        if tuple(saved[0].shape) != tuple(latent_shape):
            raise ValueError(f"draw at {tuple(latent_shape)}, the global batch's is "
                             f"{tuple(saved[0].shape)}")
        return tuple(t.to(device) for t in saved)

    return draw


def _local_batch(batch, index, count):
    b = batch["input_ids"].shape[0] // count
    n = batch["image_embeds"].shape[0] // count
    return {k: torch.from_numpy(np.array(v[(n if k in PER_IMAGE else b) * index:
                                           (n if k in PER_IMAGE else b) * (index + 1)]))
            for k, v in batch.items()}


def _train(adapter, frozen, batch, preset, mesh, draw, steps=STEPS):
    agent, vae = frozen
    trainer = Trainer(adapter, make_stage3_loss_fn(adapter, agent, vae, draw=draw),
                      TrainConfig(sharding_preset=preset or "fsdp", **TRAIN),
                      trainable_mask=adapter_trainable_mask(adapter), mesh=mesh)
    data = None if mesh is None else mesh["data"]
    local = _local_batch(batch, *((0, 1) if data is None else (data.get_local_rank(),
                                                               data.size())))
    metrics = [C.mean_metrics({k: float(v) for k, v in trainer.step(local, s).items()})
               for s in range(steps)]
    return trainer, metrics


def _eps_inputs():
    rng = np.random.RandomState(1)
    return (rng.randn(2, 8, 8, 4).astype(np.float32), np.array([901, 41], np.int32),
            rng.randn(2, 9, 128).astype(np.float32),
            np.array([[64, 64, 0, 0, 64, 64], [48, 64, 8, 0, 64, 64]], np.float32),
            rng.randn(2, 8, 8, 4).astype(np.float32))


def _ranks_scenario(rank, outdir):
    batch = dict(np.load(os.path.join(outdir, "batch.npz")))
    frozen = _frozen(outdir)
    out = {}
    for preset, shape in PRESETS.items():
        mesh = make_mesh(*shape)
        trainer, metrics = _train(_adapter(outdir), frozen, batch, preset, mesh,
                                  _saved_draw(outdir))
        out[preset] = (metrics, trainer.full_state()[0])
        if preset == "fsdp_tp":
            ckpt = CheckpointManager(os.path.join(outdir, "ckpt"))
            assert ckpt.save(STEPS, trainer)
            ckpt.wait()
            out["ckpt_state"] = trainer.full_state()
    # the default draw (a generator seeded with the step's seed): the repair
    trainer, metrics = _train(_adapter(outdir), frozen, batch, "dp", make_mesh(2, 1), None)
    out["dp_default_draw"] = (metrics, trainer.full_state()[0])
    # the model = 2 UNet's eps on both ranks' (whole) inputs
    adapter = _adapter(outdir).eval()
    group = make_mesh(1, 2)["model"].get_group()
    kept = sharding.split_unet_(adapter.unet, C.rank(), 2, group)
    with torch.no_grad():
        eps = adapter(*map(torch.from_numpy, _eps_inputs()))["noise_pred"]
    out["eps"] = (eps, kept, sorted(sharding.tp_splits(adapter)))
    return out


# -- the test process ----------------------------------------------------------


def _stage3_jax(with_weights_in):
    """The JAX stage-3 loss and its frozen consts, the adapter params, and
    the same weights written for the ranks into ``with_weights_in``."""
    import jax
    import jax.numpy as jnp

    from seed_story_torch import weights as W
    from seed_story_tpu.models.sdxl import adapter as ref_adapter
    from seed_story_tpu.models.sdxl import unet as ref_unet
    from seed_story_tpu.models.sdxl import vae as ref_vae
    from seed_story_tpu.train import stage3 as ref_stage3
    from test_torch_stage3 import LAT, PIX
    from test_torch_train import _agent_pair
    from test_torch_weights import adapter_init_args, jax_params

    jagent, agent_params, agent = _agent_pair(seed=3)
    jvae = ref_vae.AutoencoderKL(ref_vae.VAEConfig.tiny())
    consts = {"agent_params": agent_params,
              "vae_params": jax_params(jvae, jnp.zeros((1, PIX, PIX, 3)), seed=5)}
    vae = AutoencoderKL(VAEConfig.tiny())
    vae.load_state_dict(W.vae_state_dict(vae, consts["vae_params"]))
    jadapter = ref_adapter.SDXLAdapter(ref_adapter.SDXLAdapterConfig.tiny(
        unet=ref_unet.SDXLUNetConfig.tiny(**UNET)))
    params = jax_params(jadapter, seed=6, **adapter_init_args(LAT))
    adapter = SDXLAdapter(SDXLAdapterConfig.tiny(unet=SDXLUNetConfig.tiny(**UNET)))
    adapter.load_state_dict(W.adapter_state_dict(adapter, params))
    torch.save(agent.state_dict(), with_weights_in / "agent.pt")
    torch.save(vae.state_dict(), with_weights_in / "vae.pt")
    torch.save(adapter.state_dict(), with_weights_in / "adapter.pt")
    jloss = ref_stage3.make_stage3_loss_fn(jadapter, jagent, jvae)
    return jax, jnp, jloss, consts, params


def _jax_draws(jax, jnp, shape, steps):
    from seed_story_tpu.models.sdxl import schedulers as ref_sched

    out = {}
    for seed in range(steps):
        rng_noise, rng_t, rng_vae = jax.random.split(jax.random.PRNGKey(seed), 3)
        draws = (jax.random.normal(rng_noise, shape, jnp.float32),
                 ref_sched.DDPMScheduler().sample_timesteps(rng_t, shape[0]),
                 jax.random.normal(rng_vae, shape))
        out[seed] = tuple(torch.from_numpy(np.array(x)) for x in draws)
    return out


@pytest.fixture(scope="module")
def ranks_run(tmp_path_factory):
    """One spawn of two ranks; the JAX trainers of the three presets run
    here while the ranks work."""
    from seed_story_tpu.models.sdxl import adapter as ref_adapter
    from seed_story_tpu.parallel.mesh import make_mesh as jax_mesh
    from seed_story_tpu.train import trainer as ref_trainer
    from test_torch_stage3 import LAT, stage3_batch

    out = tmp_path_factory.mktemp("stage3_ranks")
    jax, jnp, jloss, consts, params = _stage3_jax(out)
    batch = stage3_batch(seed=7, with_vit=False)
    np.savez(out / "batch.npz", **batch)
    torch.save(_jax_draws(jax, jnp, (2, LAT, LAT, 4), STEPS), out / "draws.pt")
    ctx = mp.start_processes(_worker, args=(2, _free_port(), str(out)), nprocs=2, join=False,
                             start_method="spawn")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_runs = {}
    for preset, (data, model) in PRESETS.items():
        mesh = jax_mesh(data=data, model=model)
        jtrainer = ref_trainer.Trainer(
            mesh, jax.eval_shape(lambda: params), jloss,
            ref_trainer.TrainConfig(sharding_preset=preset, **TRAIN),
            trainable_mask=ref_adapter.adapter_trainable_mask(params), loss_consts=consts)
        with mesh:
            state = jtrainer.init_state(jax.tree_util.tree_map(jnp.array, params))
            # the step counter as the step returns it, so the step compiles once
            state.step = jax.device_put(state.step, jtrainer.replicated)
            metrics = []
            for step in range(STEPS):
                state, jm = jtrainer.step(state, jbatch, jax.random.PRNGKey(step))
                metrics.append({k: float(v) for k, v in jm.items()})
        jax_runs[preset] = (metrics, jax.device_get(state.params))
    deadline = time.monotonic() + 300.0
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            raise TimeoutError("the ranks did not finish in 300 s")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return out, batch, ranks, jax_runs


def _one_process(out, batch, draw):
    adapter = _adapter(str(out))
    trainer, metrics = _train(adapter, _frozen(str(out)), batch, None, None, draw)
    return trainer, metrics, adapter.state_dict()


def _assert_params(got, want, what, atol=None):
    """Every parameter within REL of its largest entry (or ``atol``)."""
    for name, w in want.items():
        w = torch.as_tensor(np.array(w))
        limit = atol if atol is not None else REL * max(float(w.abs().max()), 1e-30)
        err = float((got[name] - w).abs().max())
        assert err <= limit, (what, name, err, limit)


def _assert_metrics(got, want, what):
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        for key in sorted({"loss", "grad_norm", "lr"} & set(w)):
            assert g[key] == pytest.approx(w[key], rel=REL, abs=1e-12), (what, key)


def test_dp_stage3_draws_the_global_batch_draws(ranks_run):
    """The default draw under ``dp`` at two ranks: each rank draws the noise,
    the timesteps and the VAE's sample at the global shape and keeps its
    rows, so the steps equal the one-process steps on the global batch
    (each rank drew the same draws for its own samples before)."""
    out, batch, ranks, _ = ranks_run
    _, metrics, state = _one_process(out, batch, None)
    for r in range(2):
        got_metrics, got_params = ranks[r]["dp_default_draw"]
        _assert_metrics(got_metrics, metrics, ("dp default draw", r))
        _assert_params(got_params, state, ("dp default draw", r))


@pytest.mark.parametrize("preset", PRESETS)
def test_sharded_stage3_steps_equal_the_one_process_step_and_the_jax_trainer(ranks_run,
                                                                            preset):
    """Both ranks' steps against the one-process trainer on the global batch
    (losses, grad_norm, every parameter), and rank 0's against the JAX
    ``Trainer`` of the same preset on a 2 x 1 mesh (``fsdp_tp``: 1 x 2)."""
    from seed_story_torch import weights as W
    from test_torch_stage3 import PARAM_TOL
    from test_torch_train import _flat

    out, batch, ranks, jax_runs = ranks_run
    _, metrics, state = _one_process(out, batch, _saved_draw(str(out)))
    for r in range(2):
        got_metrics, got_params = ranks[r][preset]
        _assert_metrics(got_metrics, metrics, (preset, r))
        _assert_params(got_params, state, (preset, r))
    jmetrics, jparams = jax_runs[preset]
    _assert_metrics(ranks[0][preset][0], jmetrics, (preset, "jax"))
    adapter = _adapter(str(out))
    flat = _flat(jparams)
    want = {name: transform(np.asarray(flat[path]))
            for name, (path, transform) in W.adapter_flax_paths(adapter).items()}
    _assert_params(ranks[0][preset][1], want, (preset, "jax"), atol=PARAM_TOL)


def test_model2_unet_eps_equals_the_whole_unets(ranks_run):
    """A UNet split over ``model`` = 2 (attention by heads, GEGLU's pairs,
    ResNets with their GroupNorm groups, the time embeddings) predicts the
    whole UNet's eps on both ranks; every layer of the tiny UNet divides,
    so none is kept whole."""
    out, _, ranks, _ = ranks_run
    with torch.no_grad():
        want = _adapter(str(out)).eval()(*map(torch.from_numpy, _eps_inputs()))["noise_pred"]
    for r in range(2):
        eps, kept, split = ranks[r]["eps"]
        assert kept == []
        torch.testing.assert_close(eps, want, rtol=0, atol=REL * float(want.abs().max()))
        for part in ("attn2.to_k.weight", "attn1.to_out.0.weight", "ff.net.0.proj.bias",
                     "ff.net.2.weight", "resnets.0.conv1.weight", "resnets.0.norm2.weight",
                     "resnets.0.conv2.weight", "time_embedding.linear_1.weight",
                     "add_embedding.linear_2.weight"):
            assert any(name.endswith(part) for name in split), part
        assert not any(name.endswith(("proj_in.weight", "conv_shortcut.weight",
                                      "to_out.0.bias", "conv2.bias", "conv_in.weight"))
                       for name in split)


def test_fsdp_tp_checkpoint_resumes_at_one_rank(ranks_run):
    """A checkpoint saved at (data 1, model 2) holds the whole state (the
    GEGLU projection's halves joined in place): a one-process trainer
    restores exactly what the ranks held when they saved."""
    out, _, ranks, _ = ranks_run
    adapter = _adapter(str(out))
    agent, vae = _frozen(str(out))
    trainer = Trainer(adapter, make_stage3_loss_fn(adapter, agent, vae), TrainConfig(**TRAIN),
                      trainable_mask=adapter_trainable_mask(adapter))
    step, _ = CheckpointManager(str(out / "ckpt")).restore(trainer)
    assert step == STEPS == trainer.step_count
    params, opt = ranks[0]["ckpt_state"]
    for name, t in adapter.state_dict().items():
        assert torch.equal(t, params[name]), name
    for key in ("mu", "nu"):
        assert sorted(getattr(trainer, key)) == sorted(opt[key])
        for name, t in getattr(trainer, key).items():
            assert torch.equal(t, opt[key][name]), (key, name)


def _geglu_shard_output(ff, x, chunks):
    """The sum over two shards of ``ff`` (split with ``chunks``) of each
    shard's GEGLU and row-split output, plus the bias once."""
    total = 0.0
    for r in range(2):
        proj = sharding.split_dense(ff.net[0].proj, "col", r, 2, chunks=chunks)
        out = sharding.split_dense(ff.net[2], "row", r, 2)
        h, gate = torch.nn.functional.linear(x, proj.weight, proj.bias).chunk(2, dim=-1)
        total = total + torch.nn.functional.linear(h * torch.nn.functional.gelu(gate),
                                                   out.weight)
    return total + ff.net[2].bias


def test_geglu_shards_hold_the_same_rows_of_both_halves():
    """``net.0.proj``'s output is ``[h | gate]``: each shard holds rows r of
    the ``h`` half and the same rows of the ``gate`` half, so the shards'
    outputs add up to the whole feed-forward's; a contiguous slice would
    pair one shard's ``h`` with another part's ``gate``."""
    torch.manual_seed(0)
    ff = FeedForwardGEGLU(8, torch.float32, torch.float32)
    x = torch.randn(3, 5, 8)
    with torch.no_grad():
        want = ff(x)
        torch.testing.assert_close(_geglu_shard_output(ff, x, 2), want, rtol=0, atol=1e-6)
        assert not torch.allclose(_geglu_shard_output(ff, x, 1), want, atol=1e-3)
    shard = sharding.split_dense(ff.net[0].proj, "col", 1, 2, chunks=2)
    whole = ff.net[0].proj.weight  # 32 rows of h, then 32 of gate
    torch.testing.assert_close(shard.weight, torch.cat([whole[16:32], whole[48:64]]))
    assert shard.tp == sharding.TPSpec("col", 1, 2, None, 2)


def test_unet_split_refuses_to_cut_a_groupnorm_group():
    from seed_story_torch.ops.groupnorm import FastGroupNorm

    unet = UNet2DConditionModel(SDXLUNetConfig.tiny(**UNET))
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    with pytest.raises(ValueError, match="16 GroupNorm groups; a split of 32 would cut a group"):
        sharding.split_unet_(unet, 0, 32)
    after = unet.state_dict()  # refused before any layer was split
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    with pytest.raises(ValueError, match="would cut a group"):
        sharding.split_dense(FastGroupNorm(3, 48), "col", 0, 2)


def test_model4_keeps_an_attention_of_10_heads_whole_and_warns(caplog):
    """At ``model`` = 4 the 10-head attentions (SDXL's 640-wide blocks; 8
    wide heads here) stay whole on every rank with a warning, as the JAX
    package replicates a dim that does not divide; the 20-head ones, the
    feed-forwards, the ResNets and the time embeddings are split."""
    cfg = SDXLUNetConfig.tiny(block_out_channels=(40, 80, 160), attention_head_dim=8,
                              norm_num_groups=8, transformer_layers_per_block=(1, 1, 1),
                              layers_per_block=1)
    unet = UNet2DConditionModel(cfg)
    with caplog.at_level(logging.WARNING, logger=sharding.__name__):
        kept = sharding.split_unet_(unet, 1, 4)
    ten = [p for p, m in unet.named_modules() if p.endswith(("attn1", "attn2"))
           and m.to_q.weight.shape[0] == 80]
    assert ten and kept == ten
    assert sum("sharding fallback" in r.message and "heads (10)" in r.message
               for r in caplog.records) == len(ten)
    for path, m in unet.named_modules():
        if path.endswith(("attn1", "attn2")):
            assert (getattr(m.to_q, "tp", None) is None) == (path in ten)
            if path not in ten:
                assert m.to_q.weight.shape[0] == 160 // 4 and m.to_out[0].weight.shape[1] == 40
        if isinstance(m, ResnetBlock2D):
            assert m.norm2.num_groups == 2 and m.conv2.tp.style == "row"
    assert unet.time_embedding.linear_1.weight.shape[0] == 160 // 4
