"""Kernel C's launch plan (``seed_story_torch/ops/int8_linear.py::Int8Gemm``),
on the CPU: the K slices, which fix the order in which every output sums
its contracted axis, come from N and K alone, so a row's output does not
depend on the number of rows beside it; the slices cover the contracted
axis exactly, in whole stages; and what the launch plan may take from M
(the block width, one block or a cluster for the slices) stays within what
the kernel takes. The kernel itself runs only on the card
(``tests/test_torch_int8_gemm_gpu.py``).
"""

import pytest

from seed_story_torch.ops.int8_linear import Int8Gemm

SMS = 132  # an H100 SXM's multiprocessors
# (N, K) of W: every int8 product of the UNet at C = 640 and 1280 (q / k / v /
# out, the GEGLU projection, the output projection, attn2's to_k / to_v
# from the 2048-wide context), the 7B agent's projections, and small edges.
SHAPES = [(640, 640), (5120, 640), (640, 2560), (640, 2048), (1280, 1280), (10240, 1280),
          (1280, 5120), (1280, 2048), (4096, 4096), (11008, 4096), (4096, 11008), (192, 320),
          (64, 64), (128, 4096)]
ROWS = [33, 64, 65, 74, 127, 128, 129, 200, 394, 900, 2048, 2560, 8192, 65535 * 128]


def _planner():
    gemm = Int8Gemm()
    gemm._sms["card"] = SMS  # no device to ask on the CPU
    return gemm


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("n,k", SHAPES)
def test_k_slices_depend_on_n_and_k_alone_and_cover_k_exactly(n, k, transposed):
    gemm = _planner()
    stages = (n if transposed else k) // Int8Gemm.STAGE
    per_slice, slices = Int8Gemm.plan(n, k, transposed, SMS)
    assert 1 <= slices <= Int8Gemm.MAX_SLICES
    assert (slices - 1) * per_slice < stages <= slices * per_slice  # none empty, K covered
    if slices > 1:
        assert per_slice >= Int8Gemm.MIN_SLICE_STAGES
    for m in ROWS:
        bn, launch_per_slice, split = gemm.launch_plan("card", m, n, k, transposed)
        assert launch_per_slice == per_slice, m  # the same sums for every M
        assert bn in (128, 256)
        assert not (split and slices == 1), m
        if slices > 1 and not split:
            assert bn == 128, m  # one block keeps the finished slices' sum in registers


def test_small_grids_split_and_large_grids_do_not():
    """attn2's to_k / to_v (128 rows onto the 2048-wide context) run their
    K slices on a cluster; the same weights at 2048 rows add them on one
    block; the 7B projections take no slices and 256-column blocks at a
    900-row prefill, 128-column blocks at a 74-row one."""
    gemm = _planner()
    for n in (640, 1280):
        assert Int8Gemm.plan(n, 2048, False, SMS)[1] > 1
        assert gemm.launch_plan("card", 128, n, 2048, False)[2]
        assert not gemm.launch_plan("card", 2048, n, 2048, False)[2]
    for n, k in ((4096, 4096), (11008, 4096), (4096, 11008)):
        assert Int8Gemm.plan(n, k, False, SMS)[1] == 1
        assert gemm.launch_plan("card", 900, n, k, False)[0] == 256
    assert gemm.launch_plan("card", 74, 4096, 4096, False)[0] == 128
