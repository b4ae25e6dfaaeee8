"""The port's parallel layer on the CPU: collectives at world sizes 1 and 2,
the contrastive loss across ranks, the vocabulary split over ``model``
(the embedding and the cross-entropy on vocabulary shards), the ``dp`` /
``fsdp`` / ``fsdp_tp`` trainer at 2 ranks, a ``quantize_base`` base's int8
weights sharded over ``data``, checkpoints saved at 2 ranks (FSDP, the
vocabulary split, the int8 shards) and resumed at 1, the datapipe's
default rank sharding, and the tensor-parallel decode.

Two ranks run once, as ``torch.multiprocessing.spawn`` processes over
``gloo`` (one torch thread a rank), started from the environment through
``initialize_multihost``; each writes what it computed to a file, and the
checks run here against the one-process port and the JAX package (the JAX
trainers run while the ranks work). Inputs come from seeded numpy.

Tolerances: trainer losses and grad norms 1e-5 relative; parameters 1e-5
relative to the largest entry of each against the one-process port, and
1e-5 absolute against the JAX trainer (``test_torch_train.py``'s
``PARAM_TOL``: the one-process port already parts from JAX by up to
3.7e-5 of a LoRA A matrix's largest entry after 2 steps on this batch,
where Adam's normalized update turns the f32 rounding of near-zero
gradient entries into whole update steps); the contrastive loss 1e-5
relative; the vocabulary-parallel CE 1e-6 absolute against whole-logit CE
(value and gradients); decode tokens exactly; gathered int8 weights,
restored checkpoints and the resumed same-world step bitwise.
"""

import copy
import json
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from seed_story_torch import weights as W
from seed_story_torch.data.datapipes import JsonlStoryDataset, shard_for_host
from seed_story_torch.models import agent as port_agent
from seed_story_torch.models.discrete import contrastive_loss
from seed_story_torch.models.llama import (LlamaConfig, LlamaForCausalLM, cross_entropy_loss,
                                           lora_trainable_mask)
from seed_story_torch.parallel import collectives as C
from seed_story_torch.parallel import sharding
from seed_story_torch.parallel.mesh import DeviceGrid, make_mesh
from seed_story_torch.train.checkpoint import CheckpointManager
from seed_story_torch.train.stage2 import make_stage2_loss_fn
from seed_story_torch.train.trainer import TrainConfig, Trainer

TRAIN = dict(learning_rate=1e-3, warmup_steps=1, training_steps=10, adam_eps=1e-5)
PRESETS = ("dp", "fsdp", "fsdp_tp")
DROPOUT = 0.3
STEPS = 2  # the first step has lr 0 under warmup; the second moves the parameters
REL = 1e-5


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, scenario, outdir):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world))
    assert C.initialize_multihost(device="cpu") == (rank, world)
    try:
        result = SCENARIOS[scenario](rank, world, outdir)
        torch.save(result, os.path.join(outdir, f"{scenario}_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _spawn(scenario, outdir, world=2):
    """Starts ``world`` ranks of ``scenario``; returns the context to join."""
    return mp.start_processes(_worker, args=(world, _free_port(), scenario, str(outdir)),
                              nprocs=world, join=False, start_method="spawn")


def _join(ctx, scenario, outdir, world=2, timeout=300.0):
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            raise TimeoutError(f"{scenario}: the ranks did not finish in {timeout} s")
    return [torch.load(os.path.join(outdir, f"{scenario}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


# -- what the ranks compute ----------------------------------------------------


def _contrastive_inputs():
    rng = np.random.RandomState(11)
    return (rng.randn(8, 16).astype(np.float32), rng.randn(8, 16).astype(np.float32))


def _collectives_scenario(rank, world, outdir):
    out = {}
    x = torch.arange(6.0).reshape(3, 2) + 10 * rank
    w = torch.from_numpy(np.random.RandomState(1).randn(3 * world, 2).astype(np.float32))
    xg = x.clone().requires_grad_()
    gathered = C.all_gather(xg, "data")
    (gathered * w).sum().backward()
    out["all_gather"], out["all_gather_grad"] = gathered.detach(), xg.grad
    out["concat"] = C.concat_all_gather(x, "data")
    out["pmean"] = C.pmean(x, "data")
    out["mean_metrics"] = C.mean_metrics({"a": float(rank), "b": 2.0 + rank})
    out["process_allgather"] = C.process_allgather(torch.tensor([rank, 7]))
    out["broadcast"] = C.broadcast_object({"rank": rank})
    with C.data_parallel({"data": torch.distributed.group.WORLD}):
        out["global_mean"] = C.global_mean(torch.tensor(float(rank + 1)),
                                           torch.tensor(float(2 * rank + 1)))
    img, txt = _contrastive_inputs()
    b = img.shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    for key, axis in (("contrastive_axis", "data"), ("contrastive_step", None)):
        ti = torch.from_numpy(img[rows]).requires_grad_()
        tt = torch.from_numpy(txt[rows]).requires_grad_()
        with C.data_parallel({"data": torch.distributed.group.WORLD}):
            loss = contrastive_loss(ti, tt, torch.tensor(10.0), axis_name=axis)
        loss.backward()
        out[key] = (loss.detach(), ti.grad, tt.grad)
    ds = JsonlStoryDataset(os.path.join(outdir, "jsonl"), lambda r: r, seed=3)
    out["files"] = ds._file_stream(0)
    out["vocab"] = _vocab_losses(rank, world)
    return out


def _vocab_inputs():
    """A LLaMA whose padded vocabulary (256) has 6 padding rows, all on the
    last of two shards; hidden states, labels with ignored positions and
    targets on both shards (the last real id among them), and token ids
    from every row of the table."""
    rng = np.random.RandomState(12)
    cfg = LlamaConfig.tiny(dtype=torch.float32, vocab_size=250, padded_vocab_size=256,
                           num_hidden_layers=1, ce_chunk_size=5)
    llm = LlamaForCausalLM(cfg)
    llm.model.embed_tokens.weight.data = torch.from_numpy(
        rng.randn(256, cfg.hidden_size).astype(np.float32))
    llm.lm_head.weight.data = torch.from_numpy(
        (0.2 * rng.randn(256, cfg.hidden_size)).astype(np.float32))
    hidden = rng.randn(2, 12, cfg.hidden_size).astype(np.float32)
    labels = rng.randint(0, 250, (2, 12))
    labels[0, 3:6] = -100
    labels[1, :2] = -100
    labels[0, 7], labels[1, 5], labels[1, 8], labels[1, 9] = 0, 249, 127, 128
    ids = rng.randint(0, 256, (2, 12))
    ids[0, :3] = (0, 255, 128)
    return llm, hidden, labels, ids


def _vocab_losses(rank=None, world=None):
    """The CE of the whole logits and the chunked CE, each with its
    gradients to the hidden states and to ``lm_head``, and the embedding
    with the gradient to its table; on this rank's vocabulary shard when
    ``rank`` is given."""
    llm, hidden, labels, ids = _vocab_inputs()
    if rank is not None:
        assert sharding.split_vocab_(llm, rank, world, torch.distributed.group.WORLD)
    lab = torch.from_numpy(labels)
    out = {"rows": (llm.model.embed_tokens.weight.shape[0], llm.lm_head.weight.shape[0])}
    losses = (("whole_logits", lambda h: cross_entropy_loss(llm._logits(h), lab,
                                                            vocab=llm.vocab_shard())),
              ("chunked", lambda h: llm.chunked_loss(h, lab)))
    for key, loss_of in losses:
        h = torch.from_numpy(hidden).requires_grad_()
        llm.zero_grad(set_to_none=True)
        loss = loss_of(h)
        loss.backward()
        out[key] = (loss.detach(), h.grad, llm.lm_head.weight.grad.clone())
    w = torch.from_numpy(np.random.RandomState(13).randn(*ids.shape, 128).astype(np.float32))
    emb = llm.embed(torch.from_numpy(ids))
    (emb * w).sum().backward()
    out["embed"] = (emb.detach(), llm.model.embed_tokens.weight.grad)
    return out


def _agent(dropout, outdir, param_dtype=torch.float32):
    cfg = port_agent.AgentConfig.tiny(llm=LlamaConfig.tiny(
        dtype=torch.float32, lora_rank=4, lora_dropout=dropout, param_dtype=param_dtype,
        remat=True, ce_chunk_size=32))
    agent = port_agent.ContinuousLVLM(cfg)
    agent.load_state_dict(torch.load(os.path.join(outdir, "agent.pt"), weights_only=True))
    return agent


def _int8_agent(outdir, dropout=DROPOUT):
    from seed_story_torch.inference.common import quantize_agent_

    return quantize_agent_(_agent(dropout, outdir), base=True, kv=False)


def _int8_names(agent):
    return sorted(n for n, p in agent.named_parameters()
                  if p.dtype == torch.int8 or n.endswith("weight_scale"))


def _save(trainer, directory):
    """A checkpoint of ``trainer`` at its step; returns the whole state it holds."""
    ckpt = CheckpointManager(directory)
    assert ckpt.save(trainer.step_count, trainer)
    ckpt.wait()
    return trainer.full_state()


def _mask(agent):
    mask = lora_trainable_mask(agent)
    return {k: v or k.startswith(("input_resampler.", "output_resampler.")) for k, v in mask.items()}


IMAGE_KEYS = ("image_embeds", "embeds_cmp_mask", "embeds_gen_mask")


def _local_batch(batch, index, count):
    b = batch["input_ids"].shape[0] // count
    n = batch["image_embeds"].shape[0] // count
    return {k: torch.from_numpy(np.array(v[(n if k in IMAGE_KEYS else b) * index:
                                           (n if k in IMAGE_KEYS else b) * (index + 1)]))
            for k, v in batch.items()}


def _train(agent, preset, batch, mesh, steps=STEPS, trainer=None):
    trainer = trainer or Trainer(agent, make_stage2_loss_fn(agent),
                                 TrainConfig(sharding_preset=preset, **TRAIN),
                                 trainable_mask=_mask(agent), mesh=mesh)
    data = mesh["data"] if mesh is not None else None
    index, count = (0, 1) if data is None else (data.get_local_rank(), data.size())
    local = _local_batch(batch, index, count)
    metrics = []
    for step in range(trainer.step_count, trainer.step_count + steps):
        m = trainer.step(local, step)
        metrics.append(C.mean_metrics({k: float(v) for k, v in m.items()}))
    return trainer, metrics


def _train_scenario(rank, world, outdir):
    batch = dict(np.load(os.path.join(outdir, "batch.npz")))
    out = {}
    for preset in PRESETS:
        mesh = make_mesh(1, 2) if preset == "fsdp_tp" else make_mesh(2, 1)
        for dropout in (DROPOUT, 0.0):
            trainer, metrics = _train(_agent(dropout, outdir), preset, batch, mesh)
            params, _ = trainer.full_state()
            out[preset, dropout] = (metrics, params)
            if preset == "fsdp_tp" and dropout == DROPOUT:  # the vocabulary split over model
                llm = trainer.model.llm
                out["vocab_rows"] = tuple(sharding.to_local(t).shape[0] for t in (
                    llm.model.embed_tokens.weight, llm.lm_head.weight))
                out["ckpt_tp"] = _save(trainer, os.path.join(outdir, "ckpt_tp"))
    # f64 projections, embeddings and resamplers beside f32 norms: FSDP keeps
    # the norms whole, and the trainer averages their gradients
    trainer, metrics = _train(_agent(DROPOUT, outdir, torch.float64), "fsdp", batch,
                              make_mesh(2, 1))
    whole = sorted(n for n, p in trainer.params.items() if type(p) is torch.nn.Parameter)
    out["fsdp_mixed"] = (metrics, trainer.full_state()[0], whole)
    # a quantize_base agent: its int8 weights and scales held as each data
    # rank's rows outside FSDP, gathered by the product
    for dropout in (DROPOUT, 0.0):
        agent = _int8_agent(outdir, dropout)
        trainer, metrics = _train(agent, "fsdp", batch, make_mesh(2, 1))
        params = dict(agent.named_parameters())
        local = {n: (tuple(params[n].shape), type(params[n]) is torch.nn.Parameter)
                 for n in _int8_names(agent)}
        out["fsdp_int8", dropout] = (metrics, trainer.full_state()[0], local)
        if dropout == DROPOUT:
            out["ckpt_int8"] = _save(trainer, os.path.join(outdir, "ckpt_int8"))
    # an FSDP checkpoint after STEPS steps, the uninterrupted run on for one
    # more step, and a fresh 2-rank trainer resumed from the checkpoint for it
    mesh = make_mesh(2, 1)
    trainer, _ = _train(_agent(DROPOUT, outdir), "fsdp", batch, mesh)
    ckpt = CheckpointManager(os.path.join(outdir, "ckpt"))
    assert ckpt.save(STEPS, trainer, data_state={"rank": rank})
    ckpt.wait()
    out["ckpt_state"] = trainer.full_state()
    _, m3 = _train(None, "fsdp", batch, mesh, steps=1, trainer=trainer)
    out["uninterrupted"] = (m3, trainer.full_state())
    agent = _agent(DROPOUT, outdir)
    resumed = Trainer(agent, make_stage2_loss_fn(agent), TrainConfig(sharding_preset="fsdp", **TRAIN),
                      trainable_mask=_mask(agent), mesh=mesh)
    step, data_state = ckpt.restore(resumed)
    assert step == STEPS and data_state == {"rank": rank}
    _, m3r = _train(None, "fsdp", batch, mesh, steps=1, trainer=resumed)
    out["resumed"] = (m3r, resumed.full_state())
    return out


def _all_scenario(rank, world, outdir):
    return {"collectives": _collectives_scenario(rank, world, outdir),
            "train": _train_scenario(rank, world, outdir)}


SCENARIOS = {"all": _all_scenario}


# -- world of one process ------------------------------------------------------


def test_collectives_are_the_identity_without_a_process_group():
    x = torch.arange(6.0).reshape(3, 2)
    assert not C.is_initialized() and C.rank() == 0 and C.world_size() == 1
    assert C.all_gather(x) is x and C.pmean(x) is x
    assert torch.equal(C.concat_all_gather(x), x)
    assert C.mean_metrics({"a": 2}) == {"a": 2.0}
    assert torch.equal(C.process_allgather(torch.tensor([3])), torch.tensor([[3]]))
    assert C.broadcast_object("x") == "x" and C.data_shard() == (0, 1)
    assert C.initialize_multihost(device="cpu") == (0, 1)  # no address: nothing to start
    assert float(C.global_mean(torch.tensor(3.0), torch.tensor(0.0), floor=1.0)) == 3.0
    with pytest.raises(ValueError, match="no process group is initialized"):
        C.all_gather(x, "data")
    assert make_mesh() is None  # 1 x 1 over one process: the one-device trainer
    with pytest.raises(ValueError, match="mesh 2x1 > 1 devices"):
        make_mesh(2, 1)
    grid = make_mesh(1, 2, devices=["cpu", "cpu"])
    assert isinstance(grid, DeviceGrid) and grid.shape == {"data": 1, "model": 2}
    with pytest.raises(ValueError, match="mesh 1x2 > 1 devices"):
        make_mesh(1, 2, devices=["cpu"])


# -- two ranks -----------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks_run(tmp_path_factory):
    """One spawn of two ranks for every scenario; the JAX trainers of the
    three presets run here while the ranks work."""
    import jax
    import jax.numpy as jnp

    from seed_story_tpu.parallel.mesh import make_mesh as jax_mesh
    from seed_story_tpu.train import stage2 as ref_stage2
    from seed_story_tpu.train import trainer as ref_trainer
    from test_torch_train import _agent_pair, _stage2_mask_jax

    out = tmp_path_factory.mktemp("ranks")
    (out / "jsonl").mkdir()
    for i in range(5):
        (out / "jsonl" / f"part{i}.jsonl").write_text(json.dumps({"i": i}) + "\n")
    from test_torch_train import _int8_agent_pair

    jagent, params, agent = _agent_pair(seed=13)
    torch.save(agent.state_dict(), out / "agent.pt")
    batch = _stage2_batch()
    np.savez(out / "batch.npz", **batch)
    ctx = _spawn("all", out)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jint8, qparams, _ = _int8_agent_pair(seed=13)  # the same float tree, quantized
    jax_runs = {}
    for run, preset, ja, jp in (*((p, p, jagent, params) for p in PRESETS),
                                ("fsdp_int8", "fsdp", jint8, qparams)):
        mesh = jax_mesh(data=1, model=2) if preset == "fsdp_tp" else jax_mesh(data=2, model=1)
        jcfg = ref_trainer.TrainConfig(sharding_preset=preset, **TRAIN)
        jtrainer = ref_trainer.Trainer(mesh, jax.eval_shape(lambda: jp),
                                       ref_stage2.make_stage2_loss_fn(ja), jcfg,
                                       trainable_mask=_stage2_mask_jax(jp))
        with mesh:
            state = jtrainer.init_state(jax.tree_util.tree_map(jnp.array, jp))
            metrics = []
            for step in range(STEPS):
                state, jm = jtrainer.step(state, jbatch, jax.random.PRNGKey(step))
                metrics.append({k: float(v) for k, v in jm.items()})
        jax_runs[run] = (metrics, jax.device_get(state.params))
    return out, batch, _join(ctx, "all", out), jax_runs


@pytest.fixture(scope="module")
def collectives_run(ranks_run):
    out, _, ranks, _ = ranks_run
    return out, [r["collectives"] for r in ranks]


@pytest.fixture(scope="module")
def train_run(ranks_run):
    out, batch, ranks, jax_runs = ranks_run
    return out, batch, [r["train"] for r in ranks], jax_runs


def test_collectives_at_two_ranks(collectives_run):
    _, ranks = collectives_run
    w = torch.from_numpy(np.random.RandomState(1).randn(6, 2).astype(np.float32))
    xs = [torch.arange(6.0).reshape(3, 2) + 10 * r for r in range(2)]
    for r, got in enumerate(ranks):
        assert torch.equal(got["all_gather"], torch.cat(xs))
        assert torch.equal(got["all_gather_grad"], 2 * w[3 * r:3 * r + 3])  # summed over ranks
        assert torch.equal(got["concat"], torch.cat(xs))
        assert torch.equal(got["pmean"], (xs[0] + xs[1]) / 2)
        assert got["mean_metrics"] == {"a": 0.5, "b": 2.5}
        assert torch.equal(got["process_allgather"], torch.tensor([[0, 7], [1, 7]]))
        assert got["broadcast"] == {"rank": 0}
        # each rank's share of (1 + 2) / (1 + 3), times the 2 ranks
        assert float(got["global_mean"]) == pytest.approx(2 * (r + 1) / 4.0)


def test_datapipe_shards_files_by_rank_like_shard_for_host(collectives_run):
    from seed_story_tpu.data.datapipes import shard_for_host as jax_shard_for_host

    out, ranks = collectives_run
    full = JsonlStoryDataset(str(out / "jsonl"), lambda r: r, seed=3, host_index=0,
                             host_count=1)._file_stream(0)
    got = [r["files"] for r in ranks]
    assert got == [jax_shard_for_host(full, r, 2) for r in range(2)]
    assert got == [shard_for_host(full, r, 2) for r in range(2)]
    assert sorted(got[0] + got[1]) == sorted(full) and not set(got[0]) & set(got[1])


def test_contrastive_loss_across_two_ranks_matches_jax_shard_map(collectives_run):
    """``axis_name`` gathers the negatives without gradient and offsets the
    targets by rank * b: the ranks' mean loss equals the JAX loss under
    ``shard_map`` (tests/test_collectives.py) and the global-batch loss. In
    a trainer step without an axis name the negatives carry their gradient:
    the summed gradients are those of the global-batch loss."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from seed_story_tpu.models.discrete import contrastive_loss as jax_loss
    from seed_story_tpu.parallel.mesh import make_mesh as jax_mesh

    _, ranks = collectives_run
    img, txt = _contrastive_inputs()
    mesh = jax_mesh(data=2, model=1)

    def f(i, t):
        return jax.lax.pmean(jax_loss(i, t, jnp.float32(10.0), axis_name="data"), "data")[None]

    want = float(shard_map(f, mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=P("data"))(jnp.asarray(img), jnp.asarray(txt))[0])
    ti, tt = torch.from_numpy(img).requires_grad_(), torch.from_numpy(txt).requires_grad_()
    global_loss = contrastive_loss(ti, tt, torch.tensor(10.0))
    global_loss.backward()
    assert float(global_loss) == pytest.approx(want, rel=REL)
    for key in ("contrastive_axis", "contrastive_step"):
        mean = (float(ranks[0][key][0]) + float(ranks[1][key][0])) / 2
        assert mean == pytest.approx(want, rel=REL), key
    # the step path: the mean over ranks of each rank's gradient of its rows
    grad_i = torch.cat([ranks[r]["contrastive_step"][1] for r in range(2)]) / 2
    grad_t = torch.cat([ranks[r]["contrastive_step"][2] for r in range(2)]) / 2
    torch.testing.assert_close(grad_i, ti.grad, rtol=REL, atol=1e-7)
    torch.testing.assert_close(grad_t, tt.grad, rtol=REL, atol=1e-7)


def test_vocab_parallel_cross_entropy_equals_whole_logit_ce(collectives_run):
    """At two ranks, each holding half the vocabulary (the 6 padding rows on
    the last shard), the CE of the sharded logits and the chunked CE equal
    the whole-logit CE in value and in the gradients to the hidden states
    and to ``lm_head`` (each rank's rows of the whole gradient), within
    1e-6; the sharded embedding is the whole one bit for bit, and its
    gradient reaches each rank's own rows."""
    _, ranks = collectives_run
    want = _vocab_losses()
    for r, got in enumerate(r["vocab"] for r in ranks):
        assert got["rows"] == (128, 128)
        rows = slice(128 * r, 128 * (r + 1))
        for key in ("whole_logits", "chunked"):
            (loss, dh, dw), (wloss, wdh, wdw) = got[key], want[key]
            torch.testing.assert_close(loss, want["whole_logits"][0], rtol=0, atol=1e-6)
            torch.testing.assert_close(loss, wloss, rtol=0, atol=1e-6)
            torch.testing.assert_close(dh, wdh, rtol=0, atol=1e-6)
            torch.testing.assert_close(dw, wdw[rows], rtol=0, atol=1e-6)
        assert torch.equal(got["embed"][0], want["embed"][0])
        torch.testing.assert_close(got["embed"][1], want["embed"][1][rows], rtol=0, atol=1e-6)


def test_vocab_split_falls_back_to_whole_tables(caplog):
    """A padded vocabulary that does not divide ``model`` keeps
    ``embed_tokens`` and ``lm_head`` whole, with a warning, as the JAX
    ``logical_to_sharding`` replicates such a dim."""
    llm = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32, vocab_size=250,
                                            padded_vocab_size=255, num_hidden_layers=1))
    table, head = llm.model.embed_tokens, llm.lm_head
    with caplog.at_level("WARNING", logger=sharding.logger.name):
        assert not sharding.split_vocab_(llm, 0, 2)
    assert llm.model.embed_tokens is table and llm.lm_head is head
    assert table.weight.shape[0] == head.weight.shape[0] == 255
    assert "vocab_padded (255) does not divide mesh axis model" in caplog.text
    assert llm.vocab_shard() is None


def _stage2_batch():
    """Four samples, two images each; the two halves have different numbers
    of supervised tokens and of generated images, so a per-rank mean would
    differ from the global one."""
    from test_torch_train import tiny_batch

    batch = tiny_batch(bs=4, seed=21)
    batch["labels"][2:, 21:40] = -100
    batch["embeds_gen_mask"][7] = False
    return batch


def _one_process(batch, dropout, out, steps=STEPS, param_dtype=torch.float32):
    agent = _agent(dropout, str(out), param_dtype)
    trainer, metrics = _train(agent, None, batch, None, steps=steps)
    return trainer, metrics, agent.state_dict()


def _assert_params(got, want, what, atol=None):
    """Every parameter within REL of its largest entry (or ``atol``)."""
    for name, w in want.items():
        w = torch.as_tensor(np.asarray(w))
        limit = atol if atol is not None else REL * max(float(w.abs().max()), 1e-30)
        err = float((got[name] - w).abs().max())
        assert err <= limit, (what, name, err, limit)


def _assert_metrics(got, want, what):
    for g, w in zip(got, want):
        for key in sorted({"loss", "lm_loss", "rec_loss", "grad_norm", "lr"} & set(w)):
            assert g[key] == pytest.approx(w[key], rel=REL, abs=1e-12), (what, key)


@pytest.mark.parametrize("preset", PRESETS)
def test_sharded_steps_equal_the_one_process_step_on_the_global_batch(train_run, preset):
    """LoRA dropout on: both ranks' steps equal the one-process trainer's on
    the global batch (losses, grad_norm, every parameter)."""
    out, batch, ranks, _ = train_run
    _, metrics, state = _one_process(batch, DROPOUT, out)
    for r in range(2):
        got_metrics, got_params = ranks[r][preset, DROPOUT]
        _assert_metrics(got_metrics, metrics, (preset, r))
        _assert_params(got_params, state, (preset, r))


@pytest.mark.parametrize("preset", PRESETS)
def test_sharded_steps_match_the_jax_trainer_with_the_same_preset(train_run, preset):
    """Dropout off: the 2-rank steps against the JAX ``Trainer`` of the same
    preset on a 2 x 1 mesh (``fsdp_tp``: 1 x 2), in f32."""
    from test_torch_train import PARAM_TOL, _flat

    out, _, ranks, jax_runs = train_run
    jmetrics, jparams = jax_runs[preset]
    got_metrics, got_params = ranks[0][preset, 0.0]
    _assert_metrics(got_metrics, jmetrics, preset)
    agent = _agent(0.0, str(out))
    flat, paths = _flat(jparams), W.agent_flax_paths(agent)
    want = {}
    for name, _ in agent.named_parameters():
        path, transform = paths[name]
        want[name] = transform(np.asarray(flat[path]))
    _assert_params(got_params, want, preset, atol=PARAM_TOL)


def test_fsdp_keeps_parameters_of_a_minority_dtype_whole_and_averages_them(train_run):
    """FSDP wants one dtype among a unit's trainable parameters: with f64
    projections the f32 norms stay outside it, whole on both ranks, and the
    step still equals the one-process step on the global batch."""
    out, batch, ranks, _ = train_run
    _, metrics, state = _one_process(batch, DROPOUT, out, param_dtype=torch.float64)
    for r in range(2):
        got_metrics, got_params, whole = ranks[r]["fsdp_mixed"]
        assert whole and all(name.endswith(("layernorm.weight", "norm.weight", ".ln_q.weight",
                                            ".ln_kv.weight", ".ln_q.bias", ".ln_kv.bias",
                                            "ln_post.weight", "ln_post.bias"))
                             for name in whole), whole
        _assert_metrics(got_metrics, metrics, ("fsdp_mixed", r))
        _assert_params(got_params, state, ("fsdp_mixed", r))


def test_fsdp_tp_splits_the_vocabulary_over_model(train_run):
    """At (1, 2) ``fsdp_tp`` each rank holds ``vocab_padded / 2`` rows of
    ``embed_tokens`` and of ``lm_head``, and the tables gathered after the
    steps equal the one-process tables (the steps themselves against the
    one-process port and the JAX ``Trainer``: the ``fsdp_tp`` cases
    above)."""
    out, batch, ranks, _ = train_run
    _, _, state = _one_process(batch, DROPOUT, out)
    half = _agent(DROPOUT, str(out)).cfg.llm.vocab_padded // 2
    tables = ("llm.model.embed_tokens.weight", "llm.lm_head.weight")
    for r in range(2):
        assert ranks[r]["vocab_rows"] == (half, half)
        _assert_params(ranks[r]["fsdp_tp", DROPOUT][1], {k: state[k] for k in tables},
                       ("fsdp_tp tables", r))


def test_fsdp_shards_a_quantize_base_base_over_data(train_run):
    """Under ``fsdp`` at ``data`` = 2 each rank holds half the rows of every
    int8 weight and scale of a ``quantize_base`` base (plain parameters
    outside FSDP), gathered back bit-equal to the whole base after the
    steps; the steps equal the one-process steps on the global batch
    (LoRA dropout on) and the JAX ``Trainer``'s on the same int8 tree at
    (2, 1) ``fsdp`` (dropout off)."""
    from test_torch_train import PARAM_TOL, _flat

    out, batch, ranks, jax_runs = train_run
    agent = _int8_agent(str(out))
    names = _int8_names(agent)
    before = _int8_agent(str(out)).state_dict()
    trainer, metrics = _train(agent, None, batch, None)
    state = agent.state_dict()
    assert len(names) == 2 * 7 * 2  # weight and scale of seven projections of two layers
    for r in range(2):
        for dropout in (DROPOUT, 0.0):
            got_metrics, got_params, local = ranks[r]["fsdp_int8", dropout]
            for name in names:
                rows = before[name].shape[0]
                assert local[name] == ((rows // 2, *before[name].shape[1:]), True), name
                assert torch.equal(got_params[name], before[name]), name
        got_metrics, got_params, _ = ranks[r]["fsdp_int8", DROPOUT]
        _assert_metrics(got_metrics, metrics, ("fsdp_int8", r))
        _assert_params(got_params, {k: v for k, v in state.items()
                                    if v.is_floating_point()}, ("fsdp_int8", r))
    jmetrics, jparams = jax_runs["fsdp_int8"]
    got_metrics, got_params, _ = ranks[0]["fsdp_int8", 0.0]
    _assert_metrics(got_metrics, jmetrics, "fsdp_int8 jax")
    flat, paths = _flat(jparams), W.agent_flax_paths(agent)
    want = {}
    for name, _ in agent.named_parameters():
        path, transform = paths[name]
        want[name] = torch.from_numpy(np.asarray(transform(np.asarray(flat[path]))))
        if name in names:
            assert torch.equal(got_params[name], want[name]), name
    _assert_params(got_params, {k: v for k, v in want.items() if k not in names}, "fsdp_int8 jax",
                   atol=PARAM_TOL)


@pytest.mark.parametrize("layout", ["ckpt_tp", "ckpt_int8"])
def test_sharded_checkpoint_resumes_at_one_process(train_run, layout):
    """A checkpoint saved at (1, 2) ``fsdp_tp`` with the vocabulary split,
    or at (2, 1) ``fsdp`` with the int8 base sharded over ``data``, restores
    into a one-process trainer exactly the whole state the ranks held."""
    out, _, ranks, _ = train_run
    agent = _int8_agent(str(out)) if layout == "ckpt_int8" else _agent(DROPOUT, str(out))
    trainer = Trainer(agent, make_stage2_loss_fn(agent), TrainConfig(**TRAIN),
                      trainable_mask=_mask(agent))
    step, _ = CheckpointManager(str(out / layout)).restore(trainer)
    params, opt = ranks[0][layout]
    assert step == STEPS == trainer.step_count == opt["step"]
    assert sorted(agent.state_dict()) == sorted(params)
    for name, t in agent.state_dict().items():
        assert torch.equal(t, params[name]), name
    for key in ("mu", "nu"):
        assert sorted(getattr(trainer, key)) == sorted(opt[key])
        for name, t in getattr(trainer, key).items():
            assert torch.equal(t, opt[key][name]), (key, name)


def test_fsdp_checkpoint_saved_at_two_ranks_resumes_at_one(train_run):
    """The checkpoint holds the whole state: a fresh 2-rank trainer resumed
    from it takes the next step bitwise as the uninterrupted run did, and a
    one-process trainer restores exactly the state the 2 ranks held when
    they saved, then steps within the tolerance of the 2-rank step."""
    out, batch, ranks, _ = train_run
    for r in range(2):
        (m_u, (p_u, o_u)), (m_r, (p_r, o_r)) = ranks[r]["uninterrupted"], ranks[r]["resumed"]
        assert m_u == m_r
        for name in p_u:
            assert torch.equal(p_u[name], p_r[name]), name
        for key in ("mu", "nu"):
            for name in o_u[key]:
                assert torch.equal(o_u[key][name], o_r[key][name]), (key, name)
    with open(out / "ckpt" / str(STEPS) / "meta.json") as f:
        meta = json.load(f)
    assert meta["data_states"] == [{"rank": 0}, {"rank": 1}]
    agent = _agent(DROPOUT, str(out))
    trainer = Trainer(agent, make_stage2_loss_fn(agent), TrainConfig(**TRAIN),
                      trainable_mask=_mask(agent))
    step, data_state = CheckpointManager(str(out / "ckpt")).restore(trainer)
    assert step == STEPS and data_state == {"rank": 0}  # other world size: rank 0's
    params, opt = ranks[0]["ckpt_state"]
    for name, t in agent.state_dict().items():
        assert torch.equal(t, params[name]), name
    for key in ("mu", "nu"):
        for name, t in getattr(trainer, key).items():
            assert torch.equal(t, opt[key][name]), (key, name)
    assert trainer.step_count == opt["step"] == STEPS
    _, m3 = _train(None, None, batch, None, steps=1, trainer=trainer)
    _assert_metrics(m3, ranks[0]["uninterrupted"][0], "resumed at one rank")
    _assert_params(agent.state_dict(), ranks[0]["uninterrupted"][1][0], "resumed at one rank")


# -- tensor-parallel decode ------------------------------------------------------


def _decode_setup(quantize):
    from seed_story_torch.data.tokenizer import BOI_TOKEN_ID, EOI_TOKEN_ID, FIRST_IMG_TOKEN_ID

    llm = dict(dtype=torch.float32, lora_rank=4, quantize_base=quantize, quantize_kv=quantize)
    acfg = port_agent.AgentConfig.tiny(llm=LlamaConfig.tiny(**llm))
    nq = acfg.num_img_in_tokens
    prompt = ([1, 500, 501, BOI_TOKEN_ID] + [FIRST_IMG_TOKEN_ID + i for i in range(nq)]
              + [EOI_TOKEN_ID, 600, BOI_TOKEN_ID])
    ids_cmp = np.zeros(len(prompt), bool)
    ids_cmp[4:4 + nq] = True
    image = np.random.RandomState(0).randn(1, acfg.num_vit_tokens, acfg.vit_dim)
    return acfg, np.array(prompt), image.astype(np.float32), ids_cmp


@pytest.mark.parametrize("quantize,speculate_k", [(False, 0), (True, 3)])
def test_tp2_decode_matches_tp1_and_the_jax_mesh_generator(quantize, speculate_k):
    """``--decode_tp 2`` over two (here repeated) devices: tokens equal to
    ``tp = 1``'s, with the float agent also equal to the JAX
    ``StoryGenerator`` on a (1, 2) mesh (tests/test_sharded_generate.py),
    and the int8 agent with its int8 KV cache split by KV heads and
    speculation, whose verify passes run the split cache attention."""
    from seed_story_torch.decode.generate import GenerateConfig, StoryGenerator
    from seed_story_torch.decode.tensor_parallel import (ParallelAttention, ParallelHead,
                                                         ShardedKVCache)
    from seed_story_torch.inference.common import quantize_agent_

    from test_torch_train import _agent_pair

    acfg, prompt, image, ids_cmp = _decode_setup(quantize)
    jagent, params, agent = _agent_pair(seed=17)
    agent.eval()
    if quantize:
        quantize_agent_(agent, base=True, kv=True)
    gcfg = GenerateConfig(max_new_tokens=20, num_img_gen_tokens=acfg.num_img_out_tokens,
                          cache_capacity=256, speculate_k=speculate_k,
                          return_cache=speculate_k == 0)
    outs = []
    for tp in (1, 2):
        a = copy.deepcopy(agent)
        gen = StoryGenerator(a, gcfg, mesh=make_mesh(1, tp, devices=["cpu"] * tp))
        assert isinstance(a.llm.lm_head, ParallelHead) == (tp == 2)
        assert isinstance(a.llm.model.layers[0].self_attn, ParallelAttention) == (tp == 2)
        outs.append(gen.generate(prompt, image, np.ones(1, bool), ids_cmp))
        if tp == 2 and speculate_k == 0:
            cache = outs[-1]["cache"]
            assert isinstance(cache, ShardedKVCache) and len(cache.shards) == 2
            assert cache.shards[0].k[0].shape[1] == acfg.llm.kv_heads // 2
    np.testing.assert_array_equal(outs[0]["generate_ids"], outs[1]["generate_ids"])
    if outs[0]["img_gen_feat"] is not None:
        torch.testing.assert_close(outs[1]["img_gen_feat"], outs[0]["img_gen_feat"],
                                   rtol=1e-4, atol=1e-5)
    if quantize:
        return
    import jax
    import jax.numpy as jnp

    from seed_story_tpu.decode.generate import GenerateConfig as JGenerateConfig
    from seed_story_tpu.decode.generate import StoryGenerator as JStoryGenerator
    from seed_story_tpu.parallel.mesh import make_mesh as jax_mesh

    mesh = jax_mesh(data=1, model=2, devices=jax.devices()[:2])
    with mesh:
        jgen = JStoryGenerator(jagent, params, JGenerateConfig(
            max_new_tokens=20, num_img_gen_tokens=acfg.num_img_out_tokens,
            cache_capacity=256, prompt_bucket=32), mesh=mesh, sharding_preset="fsdp_tp")
        want = jgen.generate(prompt, jnp.asarray(image), np.ones((1,), bool), ids_cmp)
    np.testing.assert_array_equal(outs[1]["generate_ids"], np.asarray(want["generate_ids"]))


def test_tp4_decode_matches_tp1():
    """``--decode_tp 4``: each shard holds one of the tiny agent's 4 heads
    and a quarter of its MLP; tokens equal ``tp = 1``'s."""
    from seed_story_torch.decode.generate import GenerateConfig, StoryGenerator

    from test_torch_train import _agent_pair

    acfg, prompt, image, ids_cmp = _decode_setup(False)
    _, _, agent = _agent_pair(seed=17)
    agent.eval()
    gcfg = GenerateConfig(max_new_tokens=20, num_img_gen_tokens=acfg.num_img_out_tokens,
                          cache_capacity=256)
    outs = [StoryGenerator(copy.deepcopy(agent), gcfg,
                           mesh=make_mesh(1, tp, devices=["cpu"] * tp)).generate(
                               prompt, image, np.ones(1, bool), ids_cmp) for tp in (1, 4)]
    assert outs[1]["cache"].shards[0].k[0].shape[1] == acfg.llm.kv_heads // 4
    np.testing.assert_array_equal(outs[0]["generate_ids"], outs[1]["generate_ids"])


def test_fsdp_warns_of_the_dims_it_pads():
    from seed_story_torch.parallel.sharding import padded_by_fsdp

    model = torch.nn.Sequential(torch.nn.Linear(6, 4), torch.nn.Linear(4, 3))
    assert padded_by_fsdp(model, set(), 2) == ["1.weight", "1.bias"]
    assert padded_by_fsdp(model, {model[1].bias}, 2) == ["1.weight"]
    assert padded_by_fsdp(model, set(), 1) == []


def test_lora_dropout_of_a_row_shard_is_its_columns_of_the_whole_mask():
    """Each row draws its own mask, and a row-parallel shard's columns are
    those columns of the mask over the whole input."""
    from seed_story_torch.models.llama import lora_dropout

    x = torch.ones(3, 5, 8)
    whole = lora_dropout(x, 0.5, seed=9)
    for c in range(4):
        torch.testing.assert_close(
            lora_dropout(x[..., 2 * c:2 * c + 2], 0.5, seed=9, cols=(c, 4)),
            whole[..., 2 * c:2 * c + 2], rtol=0, atol=0)
    assert not torch.equal(whole[0], whole[1])


def test_tp_decode_refuses_widths_that_do_not_divide():
    from seed_story_torch.decode.tensor_parallel import shard_llama_
    from seed_story_torch.models.llama import LlamaForCausalLM

    llm = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32))
    with pytest.raises(ValueError, match="attention heads"):
        shard_llama_(llm, ["cpu"] * 3)
