"""The CUDA flash forward against its plain PyTorch version, on the card.

The kernel has no CPU mode, so this test skips without CUDA. It imports
neither JAX nor the JAX package, so it runs on a machine that has only
PyTorch: ``python -m pytest --noconftest -m gpu tests/test_torch_flash_gpu.py``.
Tolerances (plain version in f32 from the same bf16 inputs): O max abs
2e-2 and LSE max abs 1e-3, set by bf16 rounding of P before PV.
"""

import pytest
import torch

from seed_story_torch.ops.attention import flash_fwd, mha

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
