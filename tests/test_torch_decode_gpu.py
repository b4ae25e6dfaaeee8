"""The CUDA decode kernels against their plain PyTorch versions, on the
card: the weight-only int8 product (``csrc/int8_linear.cu``) and the
small-query cache attention (``csrc/decode_attn.cu``); and that
``quantize_weight`` gives the same bits on the card as on the host.

The kernels have no CPU mode, so these tests skip without CUDA. They import
neither JAX nor the JAX package:
``python -m pytest --noconftest -m gpu tests/test_torch_decode_gpu.py``.
Tolerances: the int8 product within 1e-2 x max |y| (max) and 1e-3 x mean
|y| (mean) of the plain version from the same inputs (the same two bf16
roundings, f32 sums in another order); the attention within O max abs
2e-2 and mean 2e-3 of the plain version on f32 copies of the inputs (bf16
probabilities before PV in the kernel), the flash forward's limits.
"""

import pytest
import torch

from seed_story_torch.ops.attention import decode_attention, decode_attn
from seed_story_torch.ops.int8_linear import int8_linear, int8_linear_kernel


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the decode kernels have no CPU mode)")


def _exact_plain(x, w, scale):
    """The plain version as it is defined, its f32 sums rounded to bf16 once:
    cuBLAS may otherwise add split-K partial sums in bf16
    (``allow_bf16_reduced_precision_reduction``, on by default), which at
    some shapes moves many outputs by one bf16 spacing."""
    matmul = torch.backends.cuda.matmul
    flag = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return int8_linear(x, w, scale, implementation="plain")
    finally:
        matmul.allow_bf16_reduced_precision_reduction = flag


def _int8_inputs(m, n, k, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand(n, generator=gen, device="cuda") / (127 * k ** 0.5)
    return x, w, scale


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 4096), (11008, 4096), (640, 1280, 3, 3)])
def test_quantize_weight_gives_the_host_bits(shape):
    """An int8 weight and its scales quantized on the card equal those
    quantized on the host (what ``tools/convert_torch_weights --int8``
    writes), from bf16 and from f32 weights."""
    _card()
    from seed_story_torch.models.llama import quantize_weight

    gen = torch.Generator(device="cuda").manual_seed(len(shape))
    w = torch.randn(shape, generator=gen, device="cuda") / shape[1] ** 0.5
    for weight in (w, w.to(torch.bfloat16)):
        q, scale = quantize_weight(weight)
        q_host, scale_host = quantize_weight(weight.cpu())
        assert torch.equal(q.cpu(), q_host) and torch.equal(scale.cpu(), scale_host)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 16, 17, 20, 32])
@pytest.mark.parametrize("n,k", [(4096, 4096), (11008, 4096), (4096, 11008), (4096, 1040),
                                 (4100, 1040)])
def test_int8_linear_kernel_matches_plain(m, n, k):
    """Every row count of one n8 tile, and of two and four (9-32 rows: B
    stories' K + 1 verify blocks in lockstep); K = 1040 is not a multiple
    of the kernel's 256-column stage, and its last K slice of the cluster
    is 16 columns; N = 4100 is not a multiple of its 64-channel block.
    Every row of x differs."""
    _card()
    x, w, scale = _int8_inputs(m, n, k, seed=m + n + k)
    x = x * torch.arange(1, m + 1, device="cuda", dtype=torch.bfloat16)[:, None]
    before = int8_linear_kernel.launches
    y = int8_linear(x, w, scale)
    torch.cuda.synchronize()
    assert int8_linear_kernel.launches == before + 1
    want = _exact_plain(x, w, scale)
    assert y.dtype == torch.bfloat16 and y.shape == (m, n)
    err = (y.float() - want.float()).abs()
    assert float(err.max()) <= 1e-2 * float(want.float().abs().max())
    assert float(err.mean()) <= 1e-3 * float(want.float().abs().mean())


@pytest.mark.gpu
def test_int8_linear_kernel_is_bitwise_repeatable():
    """The K slices' sums (two slices of a cluster at this shape) are added
    in slice order, whichever block finishes first."""
    _card()
    x, w, scale = _int8_inputs(5, 11008, 4096, seed=7)
    assert torch.equal(int8_linear(x, w, scale), int8_linear(x, w, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(4096, 4096), (11008, 4096), (4096, 11008)])
def test_int8_linear_rows_are_bitwise_equal_across_row_counts(n, k):
    """The K split depends on N and K only, so the rows of a 20-row call
    (four 5-row verify blocks in lockstep) equal the same rows of 5-row
    calls bit for bit, and so do those of 10- and 32-row calls: a story
    decodes the same tokens alone or beside others."""
    _card()
    x, _, _ = _int8_inputs(32, n, k, seed=11)
    _, w, scale = _int8_inputs(1, n, k, seed=12)
    parts = torch.cat([int8_linear(x[i:i + 5], w, scale) for i in range(0, 20, 5)])
    assert torch.equal(int8_linear(x[:20], w, scale), parts)
    assert torch.equal(int8_linear(x[:10], w, scale), parts[:10])
    assert torch.equal(int8_linear(x, w, scale)[:20], parts)
    assert torch.equal(int8_linear(x[:2], w, scale), parts[:2])


@pytest.mark.gpu
def test_int8_linear_refuses_what_it_does_not_take():
    _card()
    x, w, scale = _int8_inputs(4, 256, 512, seed=2)
    with pytest.raises(TypeError):
        int8_linear_kernel(x.float(), w, scale)
    with pytest.raises(TypeError):
        int8_linear_kernel(x, w.to(torch.bfloat16), scale)
    with pytest.raises(ValueError, match="rows"):
        int8_linear_kernel(torch.cat([x] * 9), w, scale)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_linear_kernel(x[:, :500].contiguous(), w[:, :500].contiguous(), scale)


def _attention_inputs(b, hq, hkv, s, c, int8, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, hq, s, 128, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(b, hkv, c, 128, generator=gen, device="cuda")
    v = torch.randn(b, hkv, c, 128, generator=gen, device="cuda")
    if not int8:
        return q, k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    ks, vs = k.abs().amax(-1) / 127, v.abs().amax(-1) / 127
    k = torch.round(k / ks[..., None]).clamp(-127, 127).to(torch.int8)
    v = torch.round(v / vs[..., None]).clamp(-127, 127).to(torch.int8)
    return q, k, v, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("s", [1, 3, 5, 8])
@pytest.mark.parametrize("hq,hkv,c", [(32, 32, 900), (8, 2, 1100), (16, 4, 1), (16, 4, 63),
                                     (16, 4, 5248), (4, 4, 5248)])
def test_decode_attention_kernel_matches_plain(int8, s, hq, hkv, c):
    """Ragged kv_len with an empty row; C is not a multiple of the 16-key
    tile or the chunk; in batch row 2 fewer than S queries are new (q_start
    + S > kv_len); GQA 4 with S = 8 gives 32 rows, two tiles of 16, whose
    keys (C = 1100, 5248) are split over several chunks of a cluster."""
    _card()
    if c > 64:
        rows = (hq // hkv) * s
        assert decode_attn.chunking(torch.device("cuda"), 3, hkv, c, -(-rows // 16))[1] > 1
    b = 3
    q, k, v, ks, vs = _attention_inputs(b, hq, hkv, s, c, int8, seed=c + s + hq)
    kv_len = torch.tensor([c, 0, c // 3], dtype=torch.int32, device="cuda")
    q_start = (kv_len - s).clamp(min=0).to(torch.int32)
    q_start[2] = max(0, c // 3 - s + 2)
    kw = dict(kv_len=kv_len, q_start=q_start, k_scale=ks, v_scale=vs)
    before = decode_attn.launches
    out = decode_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert decode_attn.launches == before + 1
    f32 = (lambda t: t) if int8 else (lambda t: t.float())
    want = decode_attention(q.float(), f32(k), f32(v), implementation="plain", **kw)
    assert out.dtype == torch.bfloat16 and out.shape == (b, hq, s, 128)
    err = (out.float() - want).abs()
    assert float(err.max()) <= 2e-2 and float(err.mean()) <= 2e-3
    assert torch.all(out[1] == 0)  # the row with kv_len 0


@pytest.mark.gpu
def test_decode_attention_kernel_reads_a_strided_cache_prefix():
    """The model passes the valid prefix of the capacity buffers (views) and
    the (B, S, H, D) projection output seen as (B, H, S, D)."""
    _card()
    q, k, v, ks, vs = _attention_inputs(1, 8, 8, 5, 640, True, seed=9)
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    limit = 517
    kw = dict(kv_len=torch.tensor([limit], dtype=torch.int32, device="cuda"),
              q_start=torch.tensor([limit - 5], dtype=torch.int32, device="cuda"))
    out = decode_attention(q, k[:, :, :limit], v[:, :, :limit], k_scale=ks[:, :, :limit],
                           v_scale=vs[:, :, :limit], **kw)
    want = decode_attention(q.float(), k[:, :, :limit], v[:, :, :limit], k_scale=ks[:, :, :limit],
                            v_scale=vs[:, :, :limit], implementation="plain", **kw)
    assert float((out.float() - want).abs().max()) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [True, False])
def test_decode_attention_kernel_is_bitwise_repeatable(int8):
    """The chunks are merged in chunk order, whichever block finishes last."""
    _card()
    q, k, v, ks, vs = _attention_inputs(1, 32, 8, 5, 5248, int8, seed=11)
    kw = dict(kv_len=torch.tensor([5248], dtype=torch.int32, device="cuda"),
              q_start=torch.tensor([5243], dtype=torch.int32, device="cuda"),
              k_scale=ks, v_scale=vs)
    first = decode_attention(q, k, v, **kw)
    assert decode_attn.chunking(q.device, 1, 8, 5248, 2)[1] > 1
    for _ in range(3):
        assert torch.equal(decode_attention(q, k, v, **kw), first)


@pytest.mark.gpu
def test_decode_attention_kernel_refuses_what_it_does_not_take():
    _card()
    q, k, v, ks, vs = _attention_inputs(1, 4, 4, 1, 64, True, seed=3)
    kv_len = torch.tensor([64], dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        decode_attn(q.float(), k, v, kv_len, None, 0.1, ks, vs)
    with pytest.raises(ValueError, match="d = 128"):
        decode_attn(q[..., :64], k[..., :64], v[..., :64], kv_len, None, 0.1, ks, vs)
    with pytest.raises(ValueError, match="queries"):
        decode_attn(q.expand(1, 4, 9, 128), k, v, kv_len, kv_len, 0.1, ks, vs)
    with pytest.raises(ValueError, match="k_scale"):
        decode_attn(q, k, v, kv_len, None, 0.1)
