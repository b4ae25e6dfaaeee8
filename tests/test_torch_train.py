"""Port parity of stage-2 training, in f32 on the CPU on tiny configs:
the LLaMA training surface (chunked CE, remat, LoRA dropout, the trainable
set), the agent's losses and per-parameter gradients, the stage-2 loss with
a frozen ViT, the trainer's steps, the schedules and gradient accumulation,
each against the JAX package on the same weights.

Tolerances: losses 1e-5; gradients 1e-4 max abs relative to the largest
entry of the JAX gradient, per parameter; parameters after 1 and 3 trainer
steps 1e-5 max abs; grad_norm 1e-5 relative; schedules 1e-6 relative
(f32 in JAX, f64 here).
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
from seed_story_torch.models import agent as port_agent
from seed_story_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    LoRADense,
    cross_entropy_loss,
    lora_dropout,
    lora_trainable_mask,
)
from seed_story_torch.models.vit import VisionTransformerWithAttnPool, ViTConfig
from seed_story_torch.train import scheduler as port_sched
from seed_story_torch.train.stage2 import make_stage2_loss_fn
from seed_story_torch.train.trainer import TrainConfig, Trainer
from seed_story_tpu.models import agent as ref_agent
from seed_story_tpu.models import llama as ref_llama
from seed_story_tpu.models import vit as ref_vit
from seed_story_tpu.parallel.mesh import make_mesh
from seed_story_tpu.train import scheduler as ref_sched
from seed_story_tpu.train import stage2 as ref_stage2
from seed_story_tpu.train import trainer as ref_trainer
from test_torch_weights import agent_init_args, jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LOSS_TOL, GRAD_REL_TOL, PARAM_TOL = 1e-5, 1e-4, 1e-5


def tiny_batch(bs=2, seq=64, n_per=2, seed=0, vit_tokens=9, vit_dim=128):
    """``tests/test_trainer.py::_tiny_batch`` as numpy: one context image
    (4 in-tokens) and one generated image (9 out-tokens) per sample, labels
    on positions > 20."""
    rng = np.random.RandomState(seed)
    n = bs * n_per
    ids = rng.randint(100, 31000, size=(bs, seq)).astype(np.int32)
    ids_cmp, ids_gen = np.zeros((bs, seq), bool), np.zeros((bs, seq), bool)
    emb_cmp, emb_gen = np.zeros(n, bool), np.zeros(n, bool)
    for b in range(bs):
        ids_cmp[b, 4:8] = True
        emb_cmp[b * n_per] = True
        ids_gen[b, 30:39] = True
        emb_gen[b * n_per + 1] = True
    return {
        "input_ids": ids,
        "attention_mask": np.ones((bs, seq), np.int32),
        "labels": np.where(np.arange(seq)[None] > 20, ids, -100).astype(np.int32),
        "image_embeds": rng.randn(n, vit_tokens, vit_dim).astype(np.float32),
        "embeds_cmp_mask": emb_cmp, "embeds_gen_mask": emb_gen,
        "ids_cmp_mask": ids_cmp, "ids_gen_mask": ids_gen,
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _agent_pair(seed=7, **llm):
    """JAX agent + its params (numpy) and the port agent carrying them."""
    llm = dict(dtype=jnp.float32, lora_rank=4, lora_dropout=0.0, **llm)
    jcfg = ref_agent.AgentConfig.tiny(llm=ref_llama.LlamaConfig.tiny(**llm))
    jagent = ref_agent.ContinuousLVLM(jcfg)
    params = jax_params(jagent, seed=seed, **agent_init_args(jcfg))
    llm["dtype"] = torch.float32
    agent = port_agent.ContinuousLVLM(port_agent.AgentConfig.tiny(llm=LlamaConfig.tiny(**llm)))
    agent.load_state_dict(W.agent_state_dict(agent, params))
    return jagent, params, agent


def _flat(tree):
    return traverse_util.flatten_dict(nn.meta.unbox(tree), sep="/")


def _stage2_mask_jax(params):
    mask = dict(ref_llama.lora_trainable_mask(params))
    for key in ("input_resampler", "output_resampler"):
        mask[key] = jax.tree_util.tree_map(lambda _: True, mask[key])
    return mask


def _stage2_mask_port(agent):
    mask = lora_trainable_mask(agent)
    return {k: v or k.startswith(("input_resampler.", "output_resampler.")) for k, v in mask.items()}


def _assert_grads_match(agent, jgrads):
    flat = _flat(jgrads)
    paths = W.agent_flax_paths(agent)
    for name, p in agent.named_parameters():
        path, transform = paths[name]
        want = np.asarray(transform(np.asarray(flat[path])))
        got = p.grad.numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= GRAD_REL_TOL * scale, name


def test_chunked_ce_equals_full_ce_in_value_and_gradients():
    cfg = LlamaConfig.tiny(dtype=torch.float32, ce_chunk_size=8)
    model = LlamaForCausalLM(cfg)
    W.init_random_(model, seed=1)
    rng = np.random.RandomState(0)
    hidden = torch.from_numpy(rng.randn(2, 37, 128).astype(np.float32)).requires_grad_()
    labels = torch.from_numpy(rng.randint(0, 32066, size=(2, 37)))
    labels[:, :9] = -100
    chunked = model.chunked_loss(hidden, labels)
    g_chunked = torch.autograd.grad(chunked, [hidden, model.lm_head.weight])
    full = cross_entropy_loss(model._logits(hidden), labels)
    g_full = torch.autograd.grad(full, [hidden, model.lm_head.weight])
    torch.testing.assert_close(chunked, full, rtol=0, atol=1e-6)
    for a, b in zip(g_chunked, g_full):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def _llama_grads(cfg, state, seed):
    model = LlamaForCausalLM(cfg).train()
    model.load_state_dict(state)
    rng = np.random.RandomState(3)
    ids = torch.from_numpy(rng.randint(0, 32066, size=(2, 24)))
    mask = torch.ones(2, 24, dtype=torch.int32)
    mask[1, 19:] = 0
    out = model(ids, attention_mask=mask, dropout_seed=seed)
    loss = cross_entropy_loss(out["logits"], ids)
    names = [n for n, p in model.named_parameters() if "lora" in n or "embed" in n]
    params = dict(model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))


def test_remat_gives_the_gradients_of_no_remat_with_lora_dropout_on():
    cfg = LlamaConfig.tiny(dtype=torch.float32, lora_rank=4, lora_dropout=0.3)
    state = W.init_random_(LlamaForCausalLM(cfg), seed=2).state_dict()
    for k in state:  # nonzero LoRA B, so dropout on the adapter input shows in every grad
        if "lora_B" in k:
            state[k].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(len(k)))
    plain = _llama_grads(cfg, state, seed=11)
    remat = _llama_grads(dataclasses.replace(cfg, remat=True), state, seed=11)
    for name in plain:
        torch.testing.assert_close(remat[name], plain[name], rtol=0, atol=0, msg=name)
    other_seed = _llama_grads(cfg, state, seed=12)
    no_dropout = _llama_grads(dataclasses.replace(cfg, lora_dropout=0.0), state, seed=11)
    name = "model.layers.0.self_attn.q_proj.lora_B.weight"
    assert not torch.allclose(other_seed[name], plain[name])
    assert not torch.allclose(no_dropout[name], plain[name])


def test_lora_dropout_rate_scaling_and_seeding():
    x = torch.ones(200, 500)
    y = lora_dropout(x, 0.25, seed=5)
    dropped = float((y == 0).float().mean())
    assert abs(dropped - 0.25) < 0.01
    assert torch.all((y == 0) | (y == 1 / 0.75))
    assert torch.equal(lora_dropout(x, 0.25, seed=5), y)
    assert not torch.equal(lora_dropout(x, 0.25, seed=6), y)

    dense = LoRADense(16, 8, lora_rank=2, lora_dropout=0.5, dtype=torch.float32)
    W.init_random_(dense, seed=0)
    dense.lora_B.weight.data.normal_(generator=torch.Generator().manual_seed(0))
    xs = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    plain = dense.eval()(xs, dropout_seed=3)
    assert torch.equal(plain, dense(xs))  # no dropout outside training
    dense.train()
    assert torch.equal(dense(xs), plain)  # nor without a seed
    assert not torch.equal(dense(xs, dropout_seed=3), plain)
    assert torch.equal(dense(xs, dropout_seed=3), dense(xs, dropout_seed=3))


def test_trainable_set_maps_one_to_one_onto_the_jax_mask():
    jagent, params, agent = _agent_pair()
    want = {path for path, m in _flat(_stage2_mask_jax(params)).items() if m}
    paths = W.agent_flax_paths(agent)
    got = [paths[name][0] for name, m in _stage2_mask_port(agent).items() if m]
    assert len(set(got)) == len(got)
    assert set(got) == want
    assert any(p.endswith("lora_a") for p in got) and "llm/lm_head/kernel" in got


@pytest.mark.parametrize("ce_chunk_size", [0, 16])
def test_agent_losses_and_gradients_match_jax(ce_chunk_size):
    jagent, params, agent = _agent_pair(ce_chunk_size=ce_chunk_size)
    batch = tiny_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = ref_stage2.make_stage2_loss_fn(jagent)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: loss_fn(p, jbatch, jax.random.PRNGKey(0)), has_aux=True)(params)

    agent.train()
    out = agent(**_torch_batch(batch), dropout_seed=0)
    out["total_loss"].backward()
    np.testing.assert_allclose(out["total_loss"].item(), float(jloss), rtol=0, atol=LOSS_TOL)
    for key in ("lm_loss", "rec_loss"):
        np.testing.assert_allclose(out[key].item(), float(jmetrics[key]), rtol=0, atol=LOSS_TOL)
    _assert_grads_match(agent, jgrads)


def test_stage2_loss_fn_with_a_frozen_vit_matches_jax():
    jagent, params, agent = _agent_pair(seed=3)
    jvit = ref_vit.VisionTransformerWithAttnPool(ref_vit.ViTConfig.tiny(dtype=jnp.float32,
                                                                        n_queries=9))
    pixels = np.random.RandomState(4).randn(4, 3, 56, 56).astype(np.float32)
    vit_params = jax_params(jvit, jnp.asarray(pixels), seed=5)
    batch = tiny_batch(seed=1)
    batch.pop("image_embeds")
    batch["images"] = pixels
    loss_fn = ref_stage2.make_stage2_loss_fn(jagent, vit_model=jvit)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                          jax.random.PRNGKey(0), {"vit_params": vit_params}),
        has_aux=True)(params)

    vit = VisionTransformerWithAttnPool(ViTConfig.tiny(dtype=torch.float32, n_queries=9))
    vit.load_state_dict(W.vit_state_dict(vit, vit_params))
    vit.eval().requires_grad_(False)
    agent.train()
    loss, metrics = make_stage2_loss_fn(agent, vit)(_torch_batch(batch), 0)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=LOSS_TOL)
    for key in ("lm_loss", "rec_loss"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=0,
                                   atol=LOSS_TOL)
    _assert_grads_match(agent, jgrads)
    assert all(p.grad is None for p in vit.parameters())


# adam_eps 1e-5 instead of 1e-8: Adam moves every parameter by about lr
# whatever the size of its gradient once |g| >> eps, so an entry whose exact
# gradient is ~0 (one embedding entry here: 6.8e-8 in JAX, 3.5e-8 in the port,
# both f32 noise at 2e-7 of the largest entry) would step by a different
# fraction of lr in the two packages. Gradients well above 1e-5 step as with 1e-8.
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, training_steps=10, adam_eps=1e-5)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_trainer_steps_match_the_jax_trainer(n_steps):
    jagent, params, agent = _agent_pair(seed=9)
    batch = tiny_batch(seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = ref_trainer.TrainConfig(sharding_preset="dp", **TRAIN)
    mesh = make_mesh(data=1, model=1)
    abstract = jax.eval_shape(lambda: params)
    jtrainer = ref_trainer.Trainer(mesh, abstract, ref_stage2.make_stage2_loss_fn(jagent), jcfg,
                                   trainable_mask=_stage2_mask_jax(params))
    schedule = ref_sched.get_scheduler("cosine", 1e-3, 1, 10, jcfg.min_lr_ratio)
    trainer = Trainer(agent, make_stage2_loss_fn(agent), TrainConfig(**TRAIN),
                      trainable_mask=_stage2_mask_port(agent))
    tbatch = _torch_batch(batch)
    with mesh:
        state = jtrainer.init_state(jax.tree_util.tree_map(jnp.array, params))
        for step in range(n_steps):
            state, jm = jtrainer.step(state, jbatch, jax.random.PRNGKey(step))
            m = trainer.step(tbatch, step)
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=0, atol=LOSS_TOL)
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
            np.testing.assert_allclose(float(m["lr"]), float(schedule(step)), rtol=1e-6, atol=0)
    assert trainer.step_count == int(state.step) == n_steps
    flat = _flat(state.params)
    paths = W.agent_flax_paths(agent)
    for name, p in agent.named_parameters():
        path, transform = paths[name]
        np.testing.assert_allclose(p.detach().numpy(), transform(np.asarray(flat[path])),
                                   rtol=0, atol=PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("name", ["cosine", "linear", "constant", "constant_with_warmup"])
def test_schedules_match_jax(name):
    args = (name, 1e-3, 3, 10, 0.05)
    port, ref = port_sched.get_scheduler(*args), ref_sched.get_scheduler(*args)
    for step in range(14):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6, atol=1e-12)


def test_accumulating_two_equal_microbatches_equals_one_batch():
    batch = _torch_batch(tiny_batch(seed=4))
    results = []
    for accum in (1, 2):
        _, _, agent = _agent_pair(seed=5)
        trainer = Trainer(agent, make_stage2_loss_fn(agent),
                          TrainConfig(grad_accum_steps=accum, **TRAIN),
                          trainable_mask=_stage2_mask_port(agent))
        b = batch if accum == 1 else {k: torch.stack([v, v]) for k, v in batch.items()}
        metrics = [trainer.step(b, s) for s in range(2)]
        results.append((metrics, agent.state_dict()))
    (m1, sd1), (m2, sd2) = results
    for a, b in zip(m1, m2):
        torch.testing.assert_close(a["loss"], b["loss"], rtol=0, atol=1e-6)
    for k in sd1:
        torch.testing.assert_close(sd2[k], sd1[k], rtol=0, atol=1e-6, msg=k)


def _int8_agent_pair(seed):
    """The JAX agent with ``quantize_base`` on the int8 tree of
    ``quantize_llama_params`` (random float kernels quantized: random int8
    kernels with per-channel scales), and the port's ``quantize_base`` agent
    carrying the same bytes."""
    llm = dict(dtype=jnp.float32, lora_rank=4, lora_dropout=0.0)
    fcfg = ref_agent.AgentConfig.tiny(llm=ref_llama.LlamaConfig.tiny(**llm))
    params = jax_params(ref_agent.ContinuousLVLM(fcfg), seed=seed, **agent_init_args(fcfg))
    qparams = jax.tree_util.tree_map(np.asarray, ref_llama.quantize_llama_params(params))
    jagent = ref_agent.ContinuousLVLM(ref_agent.AgentConfig.tiny(
        llm=ref_llama.LlamaConfig.tiny(quantize_base=True, **llm)))
    llm["dtype"] = torch.float32
    agent = port_agent.ContinuousLVLM(port_agent.AgentConfig.tiny(
        llm=LlamaConfig.tiny(quantize_base=True, **llm)))
    agent.load_state_dict(W.agent_state_dict(agent, qparams))
    return jagent, qparams, agent


def test_quantize_base_loss_and_lora_gradients_match_jax():
    """The stage-2 loss over a frozen int8 base and the gradients of the
    trainable set (LoRA, norms, embeddings, lm_head, resamplers) against
    ``jax.value_and_grad`` over the same set of the JAX tree; the int8
    weights and scales take no gradient."""
    jagent, qparams, agent = _int8_agent_pair(seed=13)
    batch = tiny_batch(seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = ref_stage2.make_stage2_loss_fn(jagent)
    leaves, treedef = jax.tree_util.tree_flatten(qparams)
    trained = jax.tree_util.tree_leaves(_stage2_mask_jax(qparams))

    def loss_of(train_leaves):
        it = iter(train_leaves)
        full = [next(it) if t else leaf for leaf, t in zip(leaves, trained)]
        return loss_fn(jax.tree_util.tree_unflatten(treedef, full), jbatch,
                       jax.random.PRNGKey(0))

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        [jnp.asarray(leaf) for leaf, t in zip(leaves, trained) if t])
    paths = ["/".join(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(qparams)[0]]
    jgrad = dict(zip([p for p, t in zip(paths, trained) if t], jgrads))

    mask = _stage2_mask_port(agent)
    for name, p in agent.named_parameters():
        p.requires_grad_(mask[name])
    agent.train()
    out = agent(**_torch_batch(batch), dropout_seed=0)
    out["total_loss"].backward()
    np.testing.assert_allclose(out["total_loss"].item(), float(jloss), rtol=0, atol=LOSS_TOL)
    for key in ("lm_loss", "rec_loss"):
        np.testing.assert_allclose(out[key].item(), float(jmetrics[key]), rtol=0, atol=LOSS_TOL)
    flax_paths = W.agent_flax_paths(agent)
    n_int8 = 0
    for name, p in agent.named_parameters():
        if p.dtype == torch.int8 or name.endswith("weight_scale"):
            assert not mask[name] and p.grad is None, name
            n_int8 += p.dtype == torch.int8
            continue
        path, transform = flax_paths[name]
        if not mask[name]:
            assert path not in jgrad and p.grad is None, name
            continue
        want = np.asarray(transform(np.asarray(jgrad[path])))
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(p.grad.numpy() - want).max()) <= GRAD_REL_TOL * scale, name
    assert n_int8 == 7 * agent.cfg.llm.num_hidden_layers


def test_quantize_base_trainer_steps_match_the_jax_trainer():
    """3 steps of the port's ``Trainer`` against the JAX ``Trainer`` on the
    same int8 tree (the JAX trainer keeps the frozen int8 leaves out of its
    optimizer): losses, grad norms and the trained parameters after each,
    and the int8 base and its scales bit for bit unchanged."""
    jagent, qparams, agent = _int8_agent_pair(seed=17)
    batch = tiny_batch(seed=6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jcfg = ref_trainer.TrainConfig(sharding_preset="dp", **TRAIN)
    mesh = make_mesh(data=1, model=1)
    jtrainer = ref_trainer.Trainer(mesh, jax.eval_shape(lambda: qparams),
                                   ref_stage2.make_stage2_loss_fn(jagent), jcfg,
                                   trainable_mask=_stage2_mask_jax(qparams))
    frozen = {k: v.clone() for k, v in agent.state_dict().items()
              if v.dtype == torch.int8 or k.endswith("weight_scale")}
    trainer = Trainer(agent, make_stage2_loss_fn(agent), TrainConfig(**TRAIN),
                      trainable_mask=_stage2_mask_port(agent))
    assert not any(p.dtype == torch.int8 for p in trainer.params.values())
    tbatch = _torch_batch(batch)
    with mesh:
        state = jtrainer.init_state(jax.tree_util.tree_map(jnp.array, qparams))
        for step in range(3):
            state, jm = jtrainer.step(state, jbatch, jax.random.PRNGKey(step))
            m = trainer.step(tbatch, step)
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=0, atol=LOSS_TOL)
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    flat = _flat(state.params)
    paths = W.agent_flax_paths(agent)
    for name, p in agent.named_parameters():
        path, transform = paths[name]
        want, p = transform(np.asarray(flat[path])), p.detach()
        if name in frozen:
            assert torch.equal(p, frozen[name]), name
            np.testing.assert_array_equal(p.numpy(), want, err_msg=name)
        else:
            np.testing.assert_allclose(p.numpy(), want, rtol=0, atol=PARAM_TOL, err_msg=name)
    lora_b = agent.llm.model.layers[0].self_attn.q_proj.lora_B.weight
    assert float(lora_b.abs().max()) > 0  # LoRA moved off its zero-free start
