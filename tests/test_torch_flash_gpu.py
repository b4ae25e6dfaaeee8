"""The CUDA flash forward and backward kernels against their plain
PyTorch versions, on the card.

The kernels have no CPU mode, so these tests skip without CUDA. They import
neither JAX nor the JAX package, so they run on a machine that has only
PyTorch: ``python -m pytest --noconftest -m gpu tests/test_torch_flash_gpu.py``.
Tolerances (plain versions in f32 from the same bf16 inputs): O max abs
2e-2 and LSE max abs 1e-3, set by bf16 rounding of P before PV; dq, dk, dv
max abs 2e-2 and mean abs 1e-2 relative to the plain gradient's max and
mean, set by bf16 rounding of P and dS.
"""

import pytest
import torch

from seed_story_torch.ops.attention import (
    flash_bwd,
    flash_fwd,
    mha,
    mha_backward_reference,
    mha_reference_lse,
)

# (causal, sq, skv, hq, hkv, d, q_start, kv_len): causal and full, GQA,
# ragged kv_len, bottom-right q_start, empty rows, head dims 64 / 104 / 128
CASES = [
    (True, 256, 256, 4, 4, 64, None, None),
    (True, 64, 320, 4, 2, 128, None, None),
    (False, 96, 256, 2, 2, 104, None, None),
    (True, 1, 384, 8, 8, 128, None, None),
    (True, 40, 90, 4, 2, 104, [-3, 20], [90, 0]),
    (False, 33, 70, 2, 1, 64, [0, 0], [70, 1]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("causal,sq,skv,hq,hkv,d,q_start,kv_len", CASES)
def test_kernel_matches_plain_on_gpu(causal, sq, skv, hq, hkv, d, q_start, kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the flash kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(sq + d)
    b = 2
    q = torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(b, hkv, skv, d, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(b, hkv, skv, d, generator=gen, device="cuda").to(torch.bfloat16)
    kv_len = torch.tensor([skv, skv - 37] if kv_len is None else kv_len, device="cuda")
    q_start = kv_len - sq if q_start is None else torch.tensor(q_start, device="cuda")
    kw = dict(causal=causal, q_start=q_start, kv_len=kv_len, with_lse=True)
    before = flash_fwd.launches
    out, lse = mha(q, k, v, implementation="kernel", **kw)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    want, want_lse = mha(q.float(), k.float(), v.float(), implementation="plain", **kw)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert float((out.float() - want).abs().max()) <= 2e-2
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    finite = torch.isfinite(want_lse)
    assert float((lse - want_lse)[finite].abs().max()) <= 1e-3
    empty = torch.isinf(want_lse[..., 0])
    assert torch.all(out[empty] == 0)


# The forward's edges: (causal, b, sq, skv, hq, hkv, d, q_start, kv_len,
# layout). Sq and Skv off the 128-row tiles and Sq <= 64 (one warpgroup),
# every head dim the models use and the TMA zero-fill pads (80, 100, 104),
# GQA, q_start < 0, kv_len = 0, and the (B, S, H, D) projection views.
EDGE_CASES = [
    (False, 2, 200, 333, 4, 4, 64, None, None, "bshd"),
    (True, 2, 129, 257, 8, 2, 128, [128, -5], [257, 100], "bshd"),
    (False, 3, 64, 256, 4, 4, 128, None, None, "bshd"),
    (False, 1, 17, 1000, 2, 1, 80, None, [1000], "bhsd"),
    (True, 2, 300, 300, 4, 4, 80, [0, -40], [300, 0], "bshd"),
    (False, 2, 77, 150, 4, 4, 104, None, [150, 91], "bshd"),
    (True, 2, 256, 64, 4, 2, 104, [-192, -100], [64, 64], "bhsd"),
    (False, 2, 1024, 64, 2, 2, 64, None, None, "bshd"),
    (False, 1, 130, 70, 2, 2, 100, None, None, "bshd"),
]


def _layout(t, layout):
    """(B, H, S, D) data as the given layout's view: "bshd" is a (B, S, H, D)
    tensor transposed, as the models pass their projections."""
    return t.transpose(1, 2).contiguous().transpose(1, 2) if layout == "bshd" else t


@pytest.mark.gpu
@pytest.mark.parametrize("causal,b,sq,skv,hq,hkv,d,q_start,kv_len,layout", EDGE_CASES)
def test_forward_edges_match_plain_on_gpu(causal, b, sq, skv, hq, hkv, d, q_start, kv_len,
                                          layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the flash kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(sq * 7 + d)
    q = _layout(torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(torch.bfloat16),
                layout)
    k, v = (_layout(torch.randn(b, hkv, skv, d, generator=gen, device="cuda")
                    .to(torch.bfloat16), layout) for _ in range(2))
    kw = dict(causal=causal, q_start=q_start, kv_len=kv_len, with_lse=True)
    # d=100 has 200-byte rows: TMA takes (B, S, H, D) views only when H * D
    # and D are multiples of 8 elements, so those go through aligned copies
    copies = 0 if all(t.stride(1) % 8 == 0 and t.stride(2) % 8 == 0 for t in (q, k, v)) else 3
    before = flash_fwd.launches, flash_fwd.padded_copies
    out, lse = mha(q, k, v, implementation="kernel", **kw)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_fwd.padded_copies) == (before[0] + 1, before[1] + copies)
    want, want_lse = mha_reference_lse(q.float(), k.float(), v.float(), causal=causal,
                                       q_start=q_start, kv_len=kv_len)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape and out.is_contiguous()
    err = (out.float() - want.float()).abs()
    assert float(err.max()) <= 2e-2 and float(err.mean()) <= 2e-3
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    finite = torch.isfinite(want_lse)
    if finite.any():
        assert float((lse - want_lse)[finite].abs().max()) <= 1e-3
    assert torch.all(out[torch.isinf(want_lse[..., 0])] == 0)


@pytest.mark.gpu
def test_misaligned_inputs_go_through_aligned_copies_on_gpu():
    """A base off the 16-byte grid: the wrapper copies q, k and v into aligned
    buffers, counts the copies, and the same kernel gives the same result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the flash kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(3)
    flat = torch.randn(3 * 2 * 4 * 150 * 64 + 1, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = flat[1:].view(3, 2, 4, 150, 64).unbind(0)  # 2-byte offset
    assert q.data_ptr() % 16 != 0
    before = flash_fwd.padded_copies
    out = mha(q, k, v, causal=True, implementation="kernel")
    torch.cuda.synchronize()
    assert flash_fwd.padded_copies == before + 3
    aligned = mha(*(t.clone() for t in (q, k, v)), causal=True, implementation="kernel")
    assert flash_fwd.padded_copies == before + 3
    assert torch.equal(out, aligned)


def _inputs(causal, sq, skv, hq, hkv, d, q_start, kv_len, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = 2
    q, do = (torch.randn(b, hq, sq, d, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, skv, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    kv_len = torch.tensor([skv, skv - 37] if kv_len is None else kv_len, device="cuda",
                          dtype=torch.int32)
    q_start = (kv_len - sq if q_start is None else torch.tensor(q_start, device="cuda")).int()
    return q, k, v, do, q_start, kv_len


# The backward's tile edges: Sq and Skv one off the 64-row tiles and the
# 128-row blocks, GQA group 4 at d=128, causal with q_start < 0.
BWD_EDGE_CASES = [
    (True, 63, 127, 8, 2, 128, None, None),
    (False, 65, 65, 4, 1, 64, None, [65, 30]),
    (True, 129, 65, 4, 4, 128, [-20, -70], [65, 40]),
    (True, 129, 127, 8, 2, 128, [-5, 0], None),
]


# Grids of 128-row blocks that fill an H100's 132 multiprocessors, so both
# kernels run their two-warpgroup instances (smaller grids take 64-row
# blocks): d=128 causal with GQA and ragged lengths, and d=64 full.
BWD_FULL_GRID_CASES = [
    (True, 200, 333, 48, 24, 128, [133, 50], [333, 170]),
    (False, 130, 260, 34, 34, 64, None, None),
]


# The SDXL UNet's cross-attention in stage 3: d=64 queries onto the
# resampler's 64 keys, fewer than one 128-key block, on a small grid and on
# the 32x32 level's full one.
BWD_UNET_CROSS_CASES = [
    (False, 257, 64, 4, 4, 64, None, None),
    (False, 1024, 64, 20, 20, 64, None, None),
]


def _assert_grads_close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        err = (g.float() - w.float()).abs()
        assert float(err.max()) <= 2e-2 * float(w.abs().max()), name
        assert float(err.mean()) <= 1e-2 * float(w.abs().mean()), name


@pytest.mark.gpu
@pytest.mark.parametrize("causal,sq,skv,hq,hkv,d,q_start,kv_len",
                         CASES + BWD_EDGE_CASES + BWD_FULL_GRID_CASES + BWD_UNET_CROSS_CASES)
def test_backward_kernels_match_plain_on_gpu(causal, sq, skv, hq, hkv, d, q_start, kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the flash kernels have no CPU mode)")
    q, k, v, do, q_start, kv_len = _inputs(causal, sq, skv, hq, hkv, d, q_start, kv_len, sq + d)
    kw = dict(causal=causal, q_start=q_start, kv_len=kv_len)
    o, lse = mha(q, k, v, implementation="kernel", with_lse=True, **kw)
    scale = d ** -0.5
    before = flash_bwd.dq_launches, flash_bwd.dkv_launches
    got = flash_bwd(q, k, v, o, lse, do, q_start, kv_len, causal, scale)
    torch.cuda.synchronize()
    assert (flash_bwd.dq_launches, flash_bwd.dkv_launches) == (before[0] + 1, before[1] + 1)
    want = mha_backward_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                  scale=scale, **kw)
    _assert_grads_close(got, want)
    empty = torch.isinf(lse[..., 0])
    assert torch.all(got[0][empty] == 0)
    for i, n in enumerate(kv_len.tolist()):  # keys past kv_len get exactly zero
        assert torch.all(got[1][i, :, max(n, 0):] == 0) and torch.all(got[2][i, :, max(n, 0):] == 0)


@pytest.mark.gpu
def test_backward_is_bitwise_repeatable_on_gpu():
    """Every dQ row is written by one block and every dK / dV row by one
    block, with no atomics: two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the flash kernels have no CPU mode)")
    causal, sq, skv, hq, hkv, d, q_start, kv_len = BWD_FULL_GRID_CASES[0]
    q, k, v, do, q_start, kv_len = _inputs(causal, sq, skv, hq, hkv, d, q_start, kv_len, 11)
    o, lse = mha(q, k, v, causal=causal, q_start=q_start, kv_len=kv_len,
                 implementation="kernel", with_lse=True)
    first = flash_bwd(q, k, v, o, lse, do, q_start, kv_len, causal, d ** -0.5)
    second = flash_bwd(q, k, v, o, lse, do, q_start, kv_len, causal, d ** -0.5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_backward_misaligned_inputs_go_through_aligned_copies_on_gpu():
    """d=100 in (B, S, H, D) views: 200-byte head strides that TMA cannot
    read, so the wrapper copies q, k, v, o and dO into aligned buffers with
    D padded to 104, counts the copies, and matches the plain backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the flash kernels have no CPU mode)")
    q, k, v, do, q_start, kv_len = _inputs(False, 77, 150, 4, 4, 100, None, None, 5)
    q, k, v, do = (_layout(t, "bshd") for t in (q, k, v, do))
    kw = dict(causal=False, q_start=q_start, kv_len=kv_len)
    o, lse = mha(q, k, v, implementation="kernel", with_lse=True, **kw)
    before = flash_bwd.padded_copies
    got = flash_bwd(q, k, v, o, lse, do, q_start, kv_len, False, 100 ** -0.5)
    torch.cuda.synchronize()
    assert flash_bwd.padded_copies == before + 5
    want = mha_backward_reference(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                  scale=100 ** -0.5, **kw)
    _assert_grads_close(got, want)


@pytest.mark.gpu
def test_gradients_through_mha_on_gpu_match_autograd_of_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the flash kernels have no CPU mode)")
    q, k, v, do, q_start, kv_len = _inputs(*CASES[4], seed=7)  # GQA, empty rows, d=104
    kw = dict(causal=True, q_start=q_start, kv_len=kv_len)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_bwd.dq_launches
    out = mha(*leaves, implementation="kernel", **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, do)
    assert flash_bwd.dq_launches == before + 1
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(mha_reference_lse(*ref, **kw)[0], ref, do.float())
    _assert_grads_close(got, want)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the flash kernel has no CPU mode)")
    q = torch.randn(1, 2, 8, 16, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        mha(q, q, q, implementation="kernel")  # f32 on CUDA: raises, no fallback
    q = torch.randn(1, 2, 8, 160, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        mha(q, q, q, implementation="kernel")


# The IP adapters' and the SD-1.5 / SD-2.1 UNets' new shapes, all d=64 in
# the (B, S, H, D) projection views: IPCrossAttention's image part onto 4
# keys (below one mma tile), the SD-2.1 cross-attention onto 77 text keys,
# the IP-Adapter's context of 77 text + 4 image keys (ragged key tiles), and
# the 5-head self-attention at 64x64. (b, sq, skv, h)
IP_CASES = [
    (2, 1024, 4, 10),
    (2, 2304, 77, 10),
    (2, 4096, 81, 5),
    (2, 576, 81, 20),
    (2, 4096, 4096, 5),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,h", IP_CASES)
def test_ip_adapter_shapes_forward_and_backward_on_gpu(b, sq, skv, h):
    """Forward (O, LSE) and backward (dq, dk, dv) against the plain versions
    at the IP adapters' key counts, no input copied for TMA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the flash kernels have no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(sq + skv)
    q, do = (_layout(torch.randn(b, h, sq, 64, generator=gen, device="cuda").to(torch.bfloat16),
                     "bshd") for _ in range(2))
    k, v = (_layout(torch.randn(b, h, skv, 64, generator=gen, device="cuda").to(torch.bfloat16),
                    "bshd") for _ in range(2))
    before = flash_fwd.launches, flash_fwd.padded_copies, flash_bwd.padded_copies
    out, lse = mha(q, k, v, causal=False, implementation="kernel", with_lse=True)
    want, want_lse = mha_reference_lse(q.float(), k.float(), v.float(), causal=False)
    err = (out.float() - want).abs()
    assert float(err.max()) <= 2e-2 and float(err.mean()) <= 2e-3
    assert float((lse - want_lse).abs().max()) <= 1e-3
    q_start = torch.zeros(b, dtype=torch.int32, device="cuda")
    kv_len = torch.full((b,), skv, dtype=torch.int32, device="cuda")
    got = flash_bwd(q, k, v, out, lse, do, q_start, kv_len, False, 64 ** -0.5)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_fwd.padded_copies, flash_bwd.padded_copies) == (
        before[0] + 1, before[1], before[2])
    _assert_grads_close(got, mha_backward_reference(q.float(), k.float(), v.float(), want,
                                                    want_lse, do.float(), causal=False))
