"""Kernel C, the int8 GEMM for more than 32 rows (``csrc/int8_gemm.cu``),
against its exact plain version, on the card.

The kernel has no CPU mode, so these tests skip without CUDA. They import
neither JAX nor the JAX package:
``python -m pytest --noconftest -m gpu tests/test_torch_int8_gemm_gpu.py``.
Tolerances, kernel A's: max |err| <= 1e-2 x max |y| and mean |err| <= 1e-3 x
mean |y| of the plain version from the same inputs with its f32 sums rounded
once (the same bf16 roundings, f32 sums in another order). Shapes: the
SDXL UNet's at 1024x1024 with the CFG pair, a flagship prefill's at the 7B
projections, the stage-2 batch (2 x 1280 rows), and ragged row counts.
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
