"""The attention probes' CUDA kernels (``csrc/probe_attn.cu``) against their
plain PyTorch versions, on the card.

The kernels have no CPU mode, so these tests skip without CUDA. They import
neither JAX nor the JAX package, so they run on a machine that has only
PyTorch: ``python -m pytest --noconftest -m gpu tests/test_torch_probes_gpu.py``.
Both sides take the same bf16 inputs; the plain versions compute in f32
with P rounded to bf16 before PV, as the kernels do. Limits: O max abs
2e-2 and mean abs 2e-3 (``PERF.md`` section 2), set by bf16 rounding of P
where the two sum S in another order; ``noexp`` by its conditioned measure
(``probe_kernels.noexp_error``) at 2e-2; the copy bit for bit. A second
call must give the same bits.
"""

import pytest
import torch

from seed_story_torch.benchmarks import probe_kernels as pk

O_MAX_ABS, O_MEAN_ABS = 2e-2, 2e-3


def _qkv(shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                 for _ in range(3))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the probe kernels have no CPU mode)")


def _close(got, want):
    err = (got.float() - want.float()).abs()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    assert float(err.max()) <= O_MAX_ABS and float(err.mean()) <= O_MEAN_ABS


# One tile of 128 keys (two of 64), one of 64 keys (the (64, 64) tile
# only), 4096 keys of one head (the ring wraps 11-21 times), and 135 heads
# (B x H not a multiple of the 132 SMs).
ATTN_SHAPES = [(2, 4, 512, 64), (1, 3, 128, 64), (3, 1, 64, 64), (1, 1, 4096, 64),
               (5, 27, 256, 64)]
ATTN_CASES = [(variant, block_q, block_kv, shape) for shape in ATTN_SHAPES
              for variant in pk.VARIANTS for block_q, block_kv in pk.TILES
              if shape[2] % block_q == 0 and shape[2] % block_kv == 0]


@pytest.mark.gpu
@pytest.mark.parametrize("variant,block_q,block_kv,shape", ATTN_CASES)
def test_attn_kernel_matches_plain_on_gpu(variant, block_q, block_kv, shape):
    _need_cuda()
    q, k, v = _qkv(shape, seed=block_q + block_kv + shape[2])
    before = pk.probe_attn.launches
    got = pk.attn(q, k, v, variant, block_q, block_kv, implementation="kernel")
    again = pk.attn(q, k, v, variant, block_q, block_kv, implementation="kernel")
    torch.cuda.synchronize()
    assert pk.probe_attn.launches == before + 2
    assert pk.probe_attn.last_plan == pk.attn_plan(*shape[:3], block_q, block_kv,
                                                   pk._sms(q.device.index))
    assert torch.equal(got, again)
    want = pk.attn(q, k, v, variant, block_q, block_kv, implementation="plain")
    if variant == "noexp":
        assert bool(torch.isfinite(got.float()).all())
        assert pk.noexp_error(q, k, got, want) <= O_MAX_ABS
    else:
        _close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("block_q,block_kv", pk.TILES)
@pytest.mark.parametrize("variant", pk.VARIANTS)
def test_attn_plan_is_what_the_card_runs_on_gpu(variant, block_q, block_kv):
    """The instance's shared memory, stages and threads are attn_plan's,
    and the card holds the planned blocks an SM (two 64-row blocks)."""
    _need_cuda()
    got = pk.attn_instance(variant, block_q, block_kv)
    plan = pk.attn_plan(1, 1, 128, block_q, block_kv, 132)
    assert {k: got[k] for k in ("smem_bytes", "stages", "threads", "blocks_per_sm")} == {
        "smem_bytes": plan.smem_bytes, "stages": plan.stages, "threads": plan.threads,
        "blocks_per_sm": plan.blocks_per_sm}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 4, 256, 64), (1, 2, 192, 64), (3, 2, 1024, 64),
                                   (1, 4, 2048, 64), (2, 2, 64, 64)])
@pytest.mark.parametrize("name", ["single_pass", "single_pass_fused_bh", "attn_packed2"])
def test_single_pass_kernels_match_plain_on_gpu(name, shape):
    """Both layouts of the single-pass template (flat heads, one or two a
    program; packed head pairs) on the clusters of ``single_pass_plan``:
    a last block whose query rows are partly past S and a key tile half
    past it (192 rows), two clusters of 8 a head (2048), a cluster of one
    (64)."""
    _need_cuda()
    q, k, v = _qkv(shape, seed=shape[2])
    kernel = {"single_pass": pk.probe_single_pass,
              "single_pass_fused_bh": pk.probe_single_pass_fused_bh,
              "attn_packed2": pk.probe_attn_packed2}[name]
    before = kernel.launches
    fn = getattr(pk, name)
    got = fn(q, k, v, implementation="kernel")
    again = fn(q, k, v, implementation="kernel")
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(got, again)
    _close(got, fn(q, k, v, implementation="plain"))


@pytest.mark.gpu
@pytest.mark.parametrize("max_cluster", [1, 2, 3])
def test_single_pass_bits_do_not_depend_on_the_plan_on_gpu(max_cluster):
    """A row's sums run over the keys in one fixed order whatever the
    clusters: 16 row blocks of S = 2048 in eight clusters of 2, in six of 3
    (two blocks wholly past S) or one block each (no multicast) give the
    bits of the two clusters of 8 the plan takes."""
    _need_cuda()
    q, k, v = _qkv((1, 2, 2048, 64), seed=3)
    want = pk.single_pass(q, k, v, implementation="kernel")
    assert pk.probe_single_pass.last_plan.cluster == pk.SP_MAX_CLUSTER
    got = pk._single_pass_launch(pk.probe_single_pass, q, k, v, 1, False, max_cluster)
    torch.cuda.synchronize()
    assert pk.probe_single_pass.last_plan.cluster == max_cluster
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 20, 1024, 64), (2, 10, 1024, 128), (1, 3, 40, 8),
                                   (2, 10, 4096, 64)])
def test_copy_kernel_is_q_plus_v_bitwise_on_gpu(shape):
    _need_cuda()
    q, k, v = _qkv(shape, seed=7)
    before = pk.probe_copy_only.launches
    got = pk.copy_only(q, k, v, implementation="kernel")
    torch.cuda.synchronize()
    assert pk.probe_copy_only.launches == before + 1
    assert torch.equal(got, q + v)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take_on_gpu():
    _need_cuda()
    q, k, v = _qkv((1, 2, 256, 64), seed=0)
    with pytest.raises(TypeError, match="bfloat16"):
        pk.single_pass(q.float(), k.float(), v.float(), implementation="kernel")
    with pytest.raises(ValueError, match="contiguous"):
        pk.attn(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, implementation="kernel")
    with pytest.raises(ValueError, match="multiple of 64"):
        pk.single_pass(*(t[:, :, :96].contiguous() for t in (q, k, v)), implementation="kernel")
    with pytest.raises(ValueError, match="head dim 64"):
        pk.attn(*(torch.zeros(1, 1, 128, 128, dtype=torch.bfloat16, device="cuda")
                  for _ in range(3)), implementation="kernel")
