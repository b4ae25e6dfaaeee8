"""Port parity of the attention backward: ``mha_backward_reference`` (the
plain version of the CUDA backward kernels) against the JAX package's Pallas
backward ``_flash_bwd`` run in interpret mode, and against ``jax.vjp`` of
``mha_reference``, on the cases of ``tests/test_torch_attention.py`` (causal
and full, GQA, ragged ``kv_len``, bottom-right ``q_start``, rows with no
visible key, head dims 64 / 104 / 128) and the CUDA backward's tile edges
from ``tests/test_torch_flash_gpu.py`` (Sq 63 / 65 / 129, Skv 65 / 127, GQA
group 4 at d=128, causal with q_start < 0). Tolerance: 1e-4 max abs in f32 on
unit-normal inputs (measured <= 4e-6).

Also the wiring that makes ``mha`` differentiable: on CPU tensors the
gradient goes through ``FlashAttention`` into the plain backward (on CUDA
tensors the same Function calls the kernels), and equals autograd through
``mha_reference_lse``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_story_torch.ops import attention as port
from seed_story_tpu.ops import attention as ref
from test_torch_attention import CASES
from test_torch_flash_gpu import BWD_EDGE_CASES

TOL = 1e-4


def _case_arrays(causal, sq, skv, hq, hkv, d, q_start, kv_len, b=2):
    rng = np.random.RandomState(sq + 3 * d)
    q = rng.randn(b, hq, sq, d).astype(np.float32)
    k = rng.randn(b, hkv, skv, d).astype(np.float32)
    v = rng.randn(b, hkv, skv, d).astype(np.float32)
    do = rng.randn(b, hq, sq, d).astype(np.float32)
    kv_len = np.asarray([skv, skv - 37] if kv_len is None else kv_len, np.int32)
    q_start = np.asarray(kv_len - sq if q_start is None else q_start, np.int32)
    return q, k, v, do, q_start, kv_len


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("causal,sq,skv,hq,hkv,d,q_start,kv_len", CASES + BWD_EDGE_CASES)
def test_plain_backward_matches_pallas_backward(causal, sq, skv, hq, hkv, d, q_start, kv_len):
    q, k, v, do, q_start, kv_len = _case_arrays(causal, sq, skv, hq, hkv, d, q_start, kv_len)
    scale = float(1.0 / np.sqrt(d))
    blocks = dict(block_q=min(256, -(-sq // 128) * 128), block_kv=min(512, -(-skv // 128) * 128))
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    out, lse = ref._flash_fwd(*jargs, jnp.asarray(q_start), jnp.asarray(kv_len), causal=causal,
                              scale=scale, interpret=True, **blocks)
    want = ref._flash_bwd(*jargs, out, lse, jnp.asarray(do), jnp.asarray(q_start),
                          jnp.asarray(kv_len), causal=causal, scale=scale, interpret=True,
                          **blocks)
    got = port.mha_backward_reference(
        *_t(q, k, v, np.asarray(out), np.asarray(lse)[:, :, :sq], do), causal=causal,
        q_start=torch.from_numpy(q_start), kv_len=torch.from_numpy(kv_len), scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("causal,sq,skv,hq,hkv,d,q_start,kv_len", CASES + BWD_EDGE_CASES)
def test_plain_backward_matches_jax_grad(causal, sq, skv, hq, hkv, d, q_start, kv_len):
    q, k, v, do, q_start, kv_len = _case_arrays(causal, sq, skv, hq, hkv, d, q_start, kv_len)
    lens = dict(q_start=jnp.asarray(q_start), kv_len=jnp.asarray(kv_len))
    _, vjp = jax.vjp(lambda q, k, v: ref.mha_reference(q, k, v, causal=causal, **lens),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = _t(q, k, v, do)
    kw = dict(causal=causal, q_start=torch.from_numpy(q_start), kv_len=torch.from_numpy(kv_len))
    o, lse = port.mha_reference_lse(tq, tk, tv, **kw)
    got = port.mha_backward_reference(tq, tk, tv, o, lse, tdo, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL, err_msg=name)
        assert np.isfinite(g.numpy()).all()
    empty = np.isinf(lse.numpy()[..., 0])
    if empty.any():  # rows with no visible key get exactly zero gradient
        assert np.all(got[0].numpy()[empty] == 0.0)


def test_gradient_through_mha_goes_through_flash_attention(monkeypatch):
    """The fault this guards: ``mha`` on the card returned the kernel's
    output with no ``grad_fn``, so training dropped every gradient through
    attention. Now both implementations go through ``FlashAttention``; here
    (CPU) its backward is the plain one."""
    calls = []
    plain_bwd = port.mha_backward_reference
    monkeypatch.setattr(port, "mha_backward_reference",
                        lambda *a, **kw: calls.append(1) or plain_bwd(*a, **kw))
    causal, sq, skv, hq, hkv, d, q_start, kv_len = CASES[4]  # GQA, empty rows, d=104
    q, k, v, do, q_start, kv_len = _case_arrays(causal, sq, skv, hq, hkv, d, q_start, kv_len)
    kw = dict(causal=causal, q_start=torch.from_numpy(q_start), kv_len=torch.from_numpy(kv_len))
    leaves = [t.requires_grad_() for t in _t(q, k, v)]
    out = port.mha(*leaves, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert calls == [1]
    ref_leaves = [t.requires_grad_() for t in _t(q, k, v)]
    want = torch.autograd.grad(port.mha_reference_lse(*ref_leaves, **kw)[0], ref_leaves,
                               torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL, msg=name)


@pytest.mark.parametrize("wrt", ["q", "kv"])
def test_gradient_with_respect_to_part_of_the_inputs(wrt):
    causal, sq, skv, hq, hkv, d, q_start, kv_len = CASES[1]  # GQA, bottom-right
    q, k, v, do, q_start, kv_len = _case_arrays(causal, sq, skv, hq, hkv, d, q_start, kv_len)
    kw = dict(causal=causal, q_start=torch.from_numpy(q_start), kv_len=torch.from_numpy(kv_len))
    tq, tk, tv = _t(q, k, v)
    diff = [tq] if wrt == "q" else [tk, tv]
    for t in diff:
        t.requires_grad_()
    got = torch.autograd.grad(port.mha(tq, tk, tv, **kw), diff, torch.from_numpy(do))
    o, lse = port.mha_reference_lse(*_t(q, k, v), **kw)
    dq, dk, dv = port.mha_backward_reference(*_t(q, k, v), o, lse, torch.from_numpy(do), **kw)
    for g, w in zip(got, [dq] if wrt == "q" else [dk, dv]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
