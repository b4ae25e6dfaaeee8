"""Port parity of the stage-1 discrete models (``seed_story_torch/models/
discrete.py``), in f32 on the CPU on tiny widths, against the JAX package on
the same weights (carried by ``seed_story_torch.weights``) and the same
numpy-seeded inputs.

Tolerances: VQ codes exactly equal; the straight-through gradient to x and
the codebook gradient 1e-5 of the JAX gradient's largest entry; every
loss 1e-5 absolute; reconstructions 1e-5 of their largest entry; after 1 and
3 ``Trainer`` steps against the JAX ``Trainer``, losses 1e-5, grad_norm 1e-5
relative, parameters 1e-5 absolute.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from seed_story_torch import weights as W
from seed_story_torch.models import discrete as port
from seed_story_torch.train.trainer import TrainConfig, Trainer
from seed_story_tpu.models import discrete as ref
from seed_story_tpu.parallel.mesh import make_mesh
from seed_story_tpu.train import trainer as ref_trainer
from test_torch_weights import jax_params

torch.backends.cuda.matmul.allow_tf32 = False

EMBED, TEXT, DIM, CODES = 24, 20, 16, 32
LOSS_TOL, REL_TOL, PARAM_TOL = 1e-5, 1e-5, 1e-5
TRAIN = dict(learning_rate=1e-2, warmup_steps=1, training_steps=10, adam_eps=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feats(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _flat(tree):
    return traverse_util.flatten_dict(nn.meta.unbox(tree), sep="/")


def _assert_rel(got, want, rel=REL_TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def _pair(jmodel, pmodel, *args, seed=0):
    params = jax_params(jmodel, *map(jnp.asarray, args), seed=seed)
    pmodel.load_state_dict(W.discrete_state_dict(pmodel, params))
    return params, pmodel


CFG = dict(dim=DIM, codebook_size=CODES)


def _vq_pair():
    x = _feats(1, (2, 7, DIM))
    jvq = ref.VectorQuantizer(CODES, DIM)
    params, vq = _pair(jvq, port.VectorQuantizer(CODES, DIM), x)
    return jvq, params, vq, x


def test_vq_codes_equal_jax_and_nearest_code():
    jvq, params, vq, x = _vq_pair()
    want = jvq.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        quant, idx, commit, codebook_loss = vq(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    cb = params["codebook"]
    d = ((x[..., None, :] - cb[None, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx.numpy(), d.argmin(-1))
    _assert_rel(quant.detach().numpy(), want[0])
    for got, w in ((commit, want[2]), (codebook_loss, want[3])):
        np.testing.assert_allclose(float(got), float(w), rtol=0, atol=LOSS_TOL)


def test_vq_straight_through_and_codebook_gradients_match_jax_vjp():
    """The loss sum(1.5 * quant) + 0.25 commit + codebook: d/dx is the
    straight-through 1.5 plus the commitment term, d/dcodebook comes from
    the codebook loss; both against ``jax.vjp``."""
    jvq, params, vq, x = _vq_pair()

    def jloss(p, xx):
        quant, _, commit, codebook_loss = jvq.apply({"params": p}, xx)
        return jnp.sum(quant * 1.5) + 0.25 * commit + codebook_loss

    _, vjp = jax.vjp(jloss, params, jnp.asarray(x))
    jgp, jgx = vjp(jnp.float32(1.0))
    xt = torch.from_numpy(x).requires_grad_()
    quant, _, commit, codebook_loss = vq(xt)
    (torch.sum(quant * 1.5) + 0.25 * commit + codebook_loss).backward()
    _assert_rel(xt.grad.numpy(), jgx, name="x")
    _assert_rel(vq.codebook.grad.numpy(), jgp["codebook"], name="codebook")
    assert float(np.abs(xt.grad.numpy() - 1.5).max()) > 0  # the commitment term is there


def _distill_pair(use_vq, seed=3):
    x = _feats(seed, (3, 6, EMBED))
    params, model = _pair(ref.DiscreteModelDistill(ref.DiscreteConfig(**CFG), use_vq=use_vq),
                          port.DiscreteModelDistill(port.DiscreteConfig(**CFG), use_vq=use_vq,
                                                    embed_dim=EMBED), x, seed=seed)
    return ref.DiscreteModelDistill(ref.DiscreteConfig(**CFG), use_vq=use_vq), params, model, x


def _check_outputs(got, want):
    assert set(got) == set(want)
    for k in want:
        if k == "codes":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        elif k == "recon":
            _assert_rel(got[k].detach().numpy(), want[k], name=k)
        else:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0, atol=LOSS_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("use_vq", [False, True])
def test_distill_losses_match_jax(use_vq):
    jmodel, params, model, x = _distill_pair(use_vq)
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        enc = model.encode_image_embeds(torch.from_numpy(x))
    _check_outputs(got, want)
    # the JAX encode_image_embeds builds its Dense outside a compact method,
    # which flax refuses; its projection (and VQ) is applied here directly
    proj = x @ params["encode_proj"]["kernel"] + params["encode_proj"]["bias"]
    if use_vq:
        proj = ref.VectorQuantizer(CODES, DIM).apply({"params": params["quantizer"]},
                                                     jnp.asarray(proj))[0]
        assert port.code_usage(got["codes"]) == ref.code_usage(want["codes"])
    _assert_rel(enc.numpy(), proj)


@pytest.mark.parametrize("name", ["DiscreteModelStageOneContrastive",
                                  "DiscreteModelStageTwoContrastiveDistill",
                                  "DiscreteModelDistillWithDoubleContrastive"])
def test_contrastive_composites_match_jax(name):
    img, txt = _feats(4, (4, 6, EMBED)), _feats(5, (4, 3, TEXT))
    if name == "DiscreteModelStageOneContrastive":
        jmodel = getattr(ref, name)(ref.DiscreteConfig(**CFG))
    else:
        jmodel = getattr(ref, name)(ref.DiscreteConfig(**CFG), use_vq=True)
    params, model = _pair(jmodel, getattr(port, name)(port.DiscreteConfig(**CFG),
                                                      embed_dim=EMBED, text_dim=TEXT),
                          img, txt, seed=6)
    want = jmodel.apply({"params": params}, jnp.asarray(img), jnp.asarray(txt))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(txt))
    _check_outputs(got, want)
    # an axis name with no process group: refused, as JAX refuses an unbound axis
    with pytest.raises(ValueError, match="no process group is initialized"):
        model(torch.from_numpy(img), torch.from_numpy(txt), axis_name="data")


def test_identity_passes_through_and_aliases_keep_the_reference_spelling():
    x = torch.arange(12.0).reshape(1, 3, 4)
    out = port.DiscreteModelIdentity()(x)
    assert out["recon"] is x and float(out["total_loss"]) == 0.0
    assert port.DiscreteModelIdentity().encode_image_embeds(x) is x
    assert not list(port.DiscreteModelIdentity().parameters())
    for alias in ("DiscreteModleIdentity", "DiscreteModleOnlyDistill",
                  "DiscreteModleStageOneContrastive", "DiscreteModleStageTwoContrastiveDistill",
                  "DiscreteModleDistillWithDoubleContrastive"):
        assert getattr(port, alias).__name__ == getattr(ref, alias).__name__
    assert port.code_usage(torch.tensor([[1, 1, 2], [7, 2, 1]])) == 3


def test_seeded_init_has_the_flax_scales():
    model = W.init_random_(port.DiscreteModelStageTwoContrastiveDistill(
        port.DiscreteConfig(dim=64, codebook_size=4096), embed_dim=EMBED), seed=0)
    with torch.no_grad():
        assert abs(float(model.distill.quantizer.codebook.std()) - 0.02) < 1e-3
        assert float(model.contrastive.logit_scale) == pytest.approx(np.log(1 / 0.07), rel=1e-6)
        assert float(model.distill.encode_proj.bias.abs().max()) == 0.0


@pytest.mark.parametrize("n_steps", [1, 3])
def test_trainer_steps_of_the_vq_distill_match_the_jax_trainer(n_steps):
    jmodel, params, model, _ = _distill_pair(True, seed=8)
    feats = _feats(9, (3, 6, EMBED))

    def jloss(p, batch, rng):
        out = jmodel.apply({"params": p}, batch["feats"])
        return out["total_loss"], {k: v for k, v in out.items()
                                   if k.endswith("loss") and k != "total_loss"}

    def loss(batch, dropout_seed):
        out = model(batch["feats"])
        return out["total_loss"], {k: v.detach() for k, v in out.items()
                                   if k.endswith("loss") and k != "total_loss"}

    mesh = make_mesh(data=1, model=1)
    jtrainer = ref_trainer.Trainer(mesh, jax.eval_shape(lambda: params), jloss,
                                   ref_trainer.TrainConfig(sharding_preset="dp", **TRAIN))
    trainer = Trainer(model, loss, TrainConfig(**TRAIN))
    paths = W.discrete_flax_paths(model)
    with mesh:
        state = jtrainer.init_state(jax.tree_util.tree_map(jnp.array, params))
        for step in range(n_steps):
            state, jm = jtrainer.step(state, {"feats": jnp.asarray(feats)},
                                      jax.random.PRNGKey(step))
            m = trainer.step({"feats": torch.from_numpy(feats)}, step)
            for k in ("loss", "distill_loss", "commit_loss", "codebook_loss"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=0, atol=LOSS_TOL,
                                           err_msg=k)
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    flat = _flat(state.params)
    for name, (path, transform) in paths.items():
        np.testing.assert_allclose(model.get_parameter(name).detach().numpy(),
                                   transform(np.asarray(flat[path])), rtol=0, atol=PARAM_TOL,
                                   err_msg=name)
    assert trainer.step_count == int(state.step) == n_steps
