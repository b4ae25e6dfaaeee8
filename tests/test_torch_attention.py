"""Port parity: ``seed_story_torch.ops.attention`` against the JAX package.

The port's plain attention (and its LSE) is held to the JAX Pallas kernel
run in interpret mode, and to ``mha_reference``, at <= 1e-5 max abs in f32.
The cases extend ``tests/test_attention.py``'s: causal and full, GQA,
ragged ``kv_len``, bottom-right ``q_start``, rows with no visible key, and
head dims 64, 104 and 128. The CUDA kernel itself is compared with the
plain version on the card (``tests/test_torch_flash_gpu.py`` and
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_story_torch.ops import attention as port
from seed_story_tpu.ops import attention as ref

# Matmuls in full f32 on every backend, so the tolerances below hold.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-5

# (causal, sq, skv, hq, hkv, d, q_start, kv_len); q_start/kv_len None ->
# test_attention.py's choice: kv_len = [skv, skv - 37], q_start = kv_len - sq
CASES = [
    (True, 256, 256, 4, 4, 64, None, None),
    (True, 64, 320, 4, 2, 128, None, None),  # GQA, bottom-right
    (False, 96, 256, 2, 2, 104, None, None),  # ViT-bigG head dim
    (True, 1, 384, 8, 8, 128, None, None),  # single query
    (True, 40, 90, 4, 2, 104, [-3, 20], [90, 0]),  # empty rows: q_start < 0, kv_len 0
    (False, 33, 70, 2, 1, 64, [0, 0], [70, 1]),
]


def _inputs(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, sq, d).astype(np.float32),
            rng.randn(b, hkv, skv, d).astype(np.float32),
            rng.randn(b, hkv, skv, d).astype(np.float32))


@pytest.mark.parametrize("causal,sq,skv,hq,hkv,d,q_start,kv_len", CASES)
def test_mha_matches_jax(causal, sq, skv, hq, hkv, d, q_start, kv_len):
    b = 2
    q, k, v = _inputs(sq + d, b, hq, hkv, sq, skv, d)
    kv_len = np.asarray([skv, skv - 37] if kv_len is None else kv_len, np.int32)
    q_start = np.asarray(kv_len - sq if q_start is None else q_start, np.int32)
    scale = 1.0 / np.sqrt(d)

    out, lse = port.mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=causal, q_start=torch.from_numpy(q_start),
                        kv_len=torch.from_numpy(kv_len), with_lse=True)
    pallas_out, pallas_lse = ref._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_start),
        jnp.asarray(kv_len), causal=causal, scale=float(scale),
        block_q=min(256, -(-sq // 128) * 128), block_kv=min(512, -(-skv // 128) * 128),
        interpret=True)
    want = ref.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             q_start=jnp.asarray(q_start), kv_len=jnp.asarray(kv_len))

    np.testing.assert_allclose(out.numpy(), np.asarray(pallas_out), rtol=0, atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=TOL)
    pallas_lse = np.asarray(pallas_lse)[:, :, :sq]
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(pallas_lse))
    finite = np.isfinite(pallas_lse)
    np.testing.assert_allclose(lse.numpy()[finite], pallas_lse[finite], rtol=0, atol=TOL)
    empty = np.isinf(pallas_lse[..., 0])
    if empty.any():  # rows with no visible key output exactly 0
        assert np.all(out.numpy()[empty] == 0.0)


@pytest.mark.parametrize("sq,hq,hkv", [(1, 8, 8), (1, 8, 2), (5, 8, 8), (5, 8, 2)])
def test_decode_attention_matches_jax(sq, hq, hkv):
    b, c, d = 3, 96, 64
    q, k, v = _inputs(sq * hkv, b, hq, hkv, sq, c, d)
    q_start = np.asarray([0, 20, 91 - sq + 5], np.int32)
    kv_len = q_start + sq
    got = port.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                kv_len=torch.from_numpy(kv_len),
                                q_start=torch.from_numpy(q_start))
    want = ref.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                kv_len=jnp.asarray(kv_len), q_start=jnp.asarray(q_start))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_dispatch_on_cpu():
    q = torch.randn(1, 2, 8, 16)
    k = torch.randn(1, 2, 8, 16)
    auto = port.mha(q, k, k, causal=True)
    torch.testing.assert_close(auto, port.mha_reference(q, k, k, causal=True), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        port.mha(q, k, k, implementation="kernel")
    with pytest.raises(ValueError, match="unknown implementation"):
        port.mha(q, k, k, implementation="xla")
    before = port.flash_fwd.launches
    port.mha(q, k, k)
    assert port.flash_fwd.launches == before  # CPU tensors never reach the kernel


@pytest.mark.parametrize("layout,heads,d,ready", [
    ("bhsd", 4, 64, True),
    ("bhsd", 4, 104, True),   # 208-byte rows
    ("bhsd", 4, 100, False),  # 200-byte rows
    ("bshd", 16, 104, True),  # the ViT's projection view
    ("bshd", 4, 100, False),  # a 200-byte head stride
    ("bshd", 1, 100, False),  # one head: its rows are 200 bytes apart
])
def test_tma_ready_follows_strides(layout, heads, d, ready):
    """TMA reads a (B, H, S, D) view in place when its base is 16-byte
    aligned and its batch, head and row strides are whole 16-byte units."""
    shape = (2, heads, 24, d) if layout == "bhsd" else (2, 24, heads, d)
    t = torch.zeros(shape, dtype=torch.bfloat16)
    view = t if layout == "bhsd" else t.transpose(1, 2)
    assert port.tma_ready(view) is ready


def test_tma_ready_refuses_offsets_and_broadcasts():
    flat = torch.zeros(2 * 3 * 5 * 64 + 1, dtype=torch.bfloat16)
    assert not port.tma_ready(flat[1:].view(2, 3, 5, 64))  # a 2-byte offset
    assert port.tma_ready(flat[:-1].view(2, 3, 5, 64))
    one_row = torch.zeros(1, 3, 1, 64, dtype=torch.bfloat16)
    assert port.tma_ready(one_row.expand(1, 3, 1, 64))  # dims of size 1: any stride
    assert not port.tma_ready(torch.zeros(1, 1, 5, 64, dtype=torch.bfloat16).expand(2, 3, 5, 64))


def test_padded_copy_is_aligned_and_zero_padded():
    t = torch.randn(2, 5, 3, 100).to(torch.bfloat16).transpose(1, 2)  # not ready
    out = port.padded_copy(t, 104)
    assert out.shape == (2, 3, 5, 104) and out.is_contiguous() and port.tma_ready(out)
    assert torch.equal(out[..., :100], t) and torch.all(out[..., 100:] == 0)


@pytest.mark.parametrize("q_start,kv_len", [(None, None), (0, 7), (np.int64(-2), None),
                                            ([1, 2], [7, 3]), (None, torch.tensor([5, 6]))])
def test_lengths_normalize_to_int32_rows(q_start, kv_len):
    qs, kl = port._normalize_lens(2, 3, 7, q_start, kv_len, "cpu")
    want_qs = np.broadcast_to(4 if q_start is None else np.asarray(q_start), (2,))
    want_kl = np.broadcast_to(7 if kv_len is None else np.asarray(kv_len), (2,))
    for got, want in ((qs, want_qs), (kl, want_kl)):
        assert got.dtype == torch.int32 and got.shape == (2,) and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
