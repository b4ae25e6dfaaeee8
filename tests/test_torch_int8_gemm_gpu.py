"""Kernel C, the int8 GEMM for more than 32 rows (``csrc/int8_gemm.cu``),
against its exact plain version, on the card.

The kernel has no CPU mode, so these tests skip without CUDA. They import
neither JAX nor the JAX package:
``python -m pytest --noconftest -m gpu tests/test_torch_int8_gemm_gpu.py``.
Tolerances, kernel A's: max |err| <= 1e-2 x max |y| and mean |err| <= 1e-3 x
mean |y| of the plain version from the same inputs with its f32 sums rounded
once (the same bf16 roundings, f32 sums in another order). Shapes: the
SDXL UNet's at 1024x1024 with the CFG pair, a flagship prefill's at the 7B
projections, the stage-2 batch (2 x 1280 rows), ragged row counts and
column tiles, the small grids of attn2's 128-row products, the launch plans
and the weights' tensor-map cache.
"""

import pytest
import torch

from seed_story_torch.ops.int8_linear import (int8_gemm_kernel, int8_linear, int8_linear_kernel,
                                              int8_linear_reference)

MAX_REL, MEAN_REL = 1e-2, 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel C has no CPU mode)")


def _no_bf16_split_k(fn):
    """``fn()`` with cuBLAS's bf16 split-K reductions off, so the plain
    version's sums are f32 throughout."""
    matmul = torch.backends.cuda.matmul
    flag = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return fn()
    finally:
        matmul.allow_bf16_reduced_precision_reduction = flag


def exact_forward(x, w, scale):
    return _no_bf16_split_k(lambda: int8_linear_reference(x, w, scale))


def exact_transposed(g, w, scale):
    """bf16(bf16(g * bf16(scale)) W) with the product's sums in f32."""
    gs = g * scale.to(torch.bfloat16)
    return (gs.float() @ w.float()).to(torch.bfloat16)


def _inputs(m, n, k, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand(n, generator=gen, device="cuda") / (127 * k ** 0.5)
    g = torch.randn(m, n, generator=gen, device="cuda").to(torch.bfloat16)
    return x, w, scale, g


def _close(got, want):
    err = (got.float() - want.float()).abs()
    assert bool(torch.isfinite(got).all())
    assert float(err.max()) <= MAX_REL * float(want.float().abs().max())
    assert float(err.mean()) <= MEAN_REL * float(want.float().abs().mean())


# (M, N, K): the UNet at 1024x1024 with the CFG pair (M = 2 x 4096 at C = 640,
# 2 x 1024 at C = 1280; (C, C), (C, 8C), (4C, C); attn2 to_k / to_v at
# M = 2 x 64 from the 2048-wide context), a flagship prefill's rows at the 7B
# projections, the stage-2 batch, and ragged M.
SHAPES = [(8192, 640, 640), (8192, 5120, 640), (8192, 640, 2560), (2048, 1280, 1280),
          (2048, 10240, 1280), (2048, 1280, 5120), (128, 640, 2048), (128, 1280, 2048),
          (900, 4096, 4096), (900, 11008, 4096), (900, 4096, 11008), (2560, 4096, 4096),
          (2560, 11008, 4096), (2560, 4096, 11008), (33, 4096, 4096), (100, 640, 640),
          (1000, 1280, 5120), (33, 192, 320)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_int8_gemm_forward_and_transposed_match_the_exact_plain_version(m, n, k):
    _card()
    x, w, scale, g = _inputs(m, n, k, seed=m + n + k)
    before = (int8_gemm_kernel.launches, int8_gemm_kernel.transposed_launches)
    y = int8_gemm_kernel(x, w, scale)
    dx = int8_gemm_kernel.transposed(g, w, scale)
    torch.cuda.synchronize()
    assert (int8_gemm_kernel.launches, int8_gemm_kernel.transposed_launches) == (
        before[0] + 2, before[1] + 1)
    assert y.shape == (m, n) and dx.shape == (m, k) and y.dtype == dx.dtype == torch.bfloat16
    _close(y, exact_forward(x, w, scale))
    _close(dx, exact_transposed(g, w, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(4096, 4096), (1280, 5120), (11008, 4096)])
def test_int8_gemm_rows_are_bitwise_equal_across_row_counts(n, k):
    """A block sums a row's whole K in one order that depends on K only, so
    rows 0-3 of a 2048-row call equal those of a 64-row call, and every row
    of a ragged 100-row call equals the same rows of the 2048-row call."""
    _card()
    x, w, scale, g = _inputs(2048, n, k, seed=n + k)
    whole = int8_gemm_kernel(x, w, scale)
    assert torch.equal(int8_gemm_kernel(x[:64].contiguous(), w, scale)[:4], whole[:4])
    assert torch.equal(int8_gemm_kernel(x[300:400].contiguous(), w, scale), whole[300:400])
    dwhole = int8_gemm_kernel.transposed(g, w, scale)
    assert torch.equal(int8_gemm_kernel.transposed(g[:64].contiguous(), w, scale)[:4],
                       dwhole[:4])
    assert torch.equal(int8_gemm_kernel(x, w, scale), whole)  # and repeatable


# Row counts around the 128-row tiles and the flagship's prefills (74-900)
# and the stage-2 batch, at a 7B projection, the UNet's C = 640 output onto
# the 2048-wide context (K slices) and the widest output, N = 11008 = 43 x 256.
EDGE_ROWS = [33, 64, 65, 74, 127, 128, 129, 394, 900, 2560]


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(4096, 4096), (640, 2048), (11008, 4096)])
@pytest.mark.parametrize("m", EDGE_ROWS)
def test_int8_gemm_ragged_row_counts_match_the_exact_plain_version(m, n, k):
    """Rows past M read as zero through TMA's fill and are not stored: both
    forms at every row count, whatever launch plan the count takes."""
    _card()
    x, w, scale, g = _inputs(m, n, k, seed=7 * m + n)
    _close(int8_gemm_kernel(x, w, scale), exact_forward(x, w, scale))
    _close(int8_gemm_kernel.transposed(g, w, scale), exact_transposed(g, w, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(100, 640, 640), (300, 640, 1280), (65, 192, 320)])
def test_int8_gemm_ragged_column_tiles_read_zeros_and_mask_their_stores(m, n, k):
    """Output widths that are no multiple of the block's: 256-column blocks
    over N = 640 or K = 640 (forced here; the launch plan takes 128 there)
    and 128-column blocks over 192 or 320 columns read zero W rows or
    columns past the edge and store nothing past it."""
    _card()
    x, w, scale, g = _inputs(m, n, k, seed=m)
    for transposed, a, want in ((False, x, exact_forward(x, w, scale)),
                                (True, g, exact_transposed(g, w, scale))):
        stages = (n if transposed else k) // 64
        for bn in (128, 256):
            _close(int8_gemm_kernel._launch(a, w, scale, transposed, (bn, stages, False)), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(640, 2048), (1280, 2048)])
def test_int8_gemm_small_grid_rows_are_bitwise_equal_across_row_counts(n, k):
    """attn2's to_k / to_v: 128 rows from the 2048-wide context give 5 or 10
    output tiles, so the K slices run on the blocks of a cluster; 33 rows do
    too, and 2048 rows add the same slices on one block. Every row gets the
    same bits in all three, in both forms."""
    _card()
    x, w, scale, g = _inputs(2048, n, k, seed=n)
    plans = {m: int8_gemm_kernel.launch_plan(x.device, m, n, k, False) for m in (33, 128, 2048)}
    assert plans[33][2] and plans[128][2] and not plans[2048][2], plans
    for f, a in ((int8_gemm_kernel, x), (int8_gemm_kernel.transposed, g)):
        whole = f(a, w, scale)
        assert torch.equal(f(a[:128].contiguous(), w, scale), whole[:128])
        assert torch.equal(f(a[:33].contiguous(), w, scale), whole[:33])
        assert torch.equal(f(a[:128].contiguous(), w, scale)[:33],
                           f(a[:33].contiguous(), w, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(900, 4096, 4096), (300, 1280, 1280), (128, 640, 2048),
                                   (200, 11008, 4096), (600, 1280, 5120)])
def test_int8_gemm_launch_plans_that_may_follow_m_give_the_same_bits(m, n, k):
    """The block width (128 or 256 columns) and whether the K slices run on
    one block or a cluster change no output's sums: the launch plan may
    follow M, the slices (``plan``, from N and K) may not. (1280, 5120) is
    sliced: its 256-column blocks split."""
    _card()
    x, w, scale, g = _inputs(m, n, k, seed=k)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    for transposed, a in ((False, x), (True, g)):
        cols = k if transposed else n
        per_slice, slices = int8_gemm_kernel.plan(n, k, transposed, sms)
        assert int8_gemm_kernel.launch_plan(x.device, m, n, k, transposed)[1] == per_slice
        plans = [(128, per_slice, False)]
        if slices > 1:
            plans.append((128, per_slice, True))
        if cols % 256 == 0:
            plans.append((256, per_slice, slices > 1))
        outs = [int8_gemm_kernel._launch(a, w, scale, transposed, p) for p in plans]
        assert all(torch.equal(outs[0], o) for o in outs[1:]), (transposed, plans)


@pytest.mark.gpu
def test_int8_gemm_map_cache_keeps_two_weights_of_one_shape_apart():
    """Each weight's tensor map is cached by (pointer, N, K, form, block
    width): two weights of one shape at two pointers each read their own
    bytes, also when the first comes back after the second."""
    _card()
    x, w1, scale, g = _inputs(96, 320, 448, seed=11)
    w2 = torch.randint(-127, 128, w1.shape, device="cuda", dtype=torch.int8)
    assert w1.data_ptr() != w2.data_ptr() and not torch.equal(w1, w2)
    for w in (w1, w2, w1, w2):
        _close(int8_gemm_kernel(x, w, scale), exact_forward(x, w, scale))
        _close(int8_gemm_kernel.transposed(g, w, scale), exact_transposed(g, w, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [33, 300])
def test_int8_linear_gradient_to_x_goes_through_kernel_c(m):
    """The autograd function: forward on kernel C, dx from its transposed
    form, against the plain product's own autograd (F.linear on the bf16
    copy) within the int8 limits; W and the scale take no gradient."""
    _card()
    x, w, scale, g = _inputs(m, 1280, 5120, seed=m)
    got = x.clone().requires_grad_()
    before = int8_gemm_kernel.transposed_launches
    int8_linear(got, w, scale).backward(g)
    assert int8_gemm_kernel.transposed_launches == before + 1
    want = x.clone().requires_grad_()
    _no_bf16_split_k(lambda: int8_linear(want, w, scale, implementation="plain").backward(g))
    _close(got.grad, want.grad)
    _close(got.grad, exact_transposed(g, w, scale))


@pytest.mark.gpu
def test_int8_linear_routes_rows_to_kernel_a_or_c():
    """``implementation="auto"`` on CUDA tensors: at most 32 rows launch
    kernel A, more launch kernel C; neither writes a bf16 copy of W."""
    _card()
    for rows, kernel in ((1, "A"), (5, "A"), (32, "A"), (33, "C"), (64, "C"), (1000, "C")):
        x, w, scale, _ = _inputs(rows, 4096, 4096, seed=rows)
        a, c = int8_linear_kernel.launches, int8_gemm_kernel.launches
        y = int8_linear(x, w, scale)
        torch.cuda.synchronize()
        assert (int8_linear_kernel.launches - a, int8_gemm_kernel.launches - c) == (
            (1, 0) if kernel == "A" else (0, 1)), rows
        _close(y, exact_forward(x, w, scale))


@pytest.mark.gpu
def test_int8_gemm_refuses_what_it_does_not_take():
    _card()
    x, w, scale, g = _inputs(40, 256, 512, seed=3)
    with pytest.raises(TypeError):
        int8_gemm_kernel(x.float(), w, scale)
    with pytest.raises(TypeError):
        int8_gemm_kernel(x, w.to(torch.bfloat16), scale)
    with pytest.raises(ValueError, match="multiples of 64"):
        int8_gemm_kernel(x[:, :480].contiguous(), w[:, :480].contiguous(), scale)
    with pytest.raises(ValueError, match="multiples of 64"):
        int8_gemm_kernel(x, w[:200].contiguous(), scale[:200].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        int8_gemm_kernel(x.t().contiguous().t(), w, scale)
    with pytest.raises(ValueError, match="bad shapes"):
        int8_gemm_kernel.transposed(x, w, scale)
    with pytest.raises(ValueError, match="on"):
        int8_gemm_kernel(x, w.cpu(), scale)
