"""The yardstick's arithmetic: one H100's peaks, and the operations and bytes
that a kernel call or a model's forward needs, counted from shapes.

Copied from the port's smoke run (``chip_smoke.py`` at the commit that added
this benchmark), so that later changes to the program do not move it:

- ``bound``: ``chip_smoke.py:419`` (``bound``);
- ``attention_work``: ``chip_smoke.py:407`` (``attention_work``), with the
  visible pairs counted from the mask rule in closed form rather than from
  the program's own mask function;
- ``flash_fwd_bound``: ``chip_smoke.py:426`` (``forward_bound``);
- ``flash_bwd_bounds``: ``chip_smoke.py:435`` (``backward_bounds``);
- ``int8_linear_bound``: ``chip_smoke.py:744-745`` (kernel A's row in
  ``phase_int8_kernel``);
- ``decode_attn_bound``: ``chip_smoke.py:1013-1016`` (kernel B's row in
  ``phase_decode_attn_kernel``).

A bound is the least time the chip could take: the larger of operations over
the bf16 peak and bytes, each read or written once, over the memory rate.
"""

from __future__ import annotations

from typing import Iterable, Sequence

# One H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float) -> float:
    """Seconds: the larger of operations over the bf16 peak and bytes over
    the memory rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def _rows(values, b: int, default: int) -> list:
    if values is None:
        return [default] * b
    values = [int(v) for v in values]
    return values * b if len(values) == 1 else values


def attention_work(b: int, hq: int, hkv: int, sq: int, skv: int, d: int, causal: bool,
                   q_start: Sequence[int] = None, kv_len: Sequence[int] = None) -> dict:
    """What these inputs need: visible (query, key) pairs summed over the
    heads, the bytes of one bf16 (B, Hq, Sq, d) tensor, of one bf16 K or V
    counting only keys some row sees, and of one f32 (B, Hq, Sq) row
    statistic. Row r's queries sit at positions ``q_start[r] + i``; under
    ``causal`` a query sees the keys at or before its position, always only
    the first ``kv_len[r]`` keys. Defaults: kv_len = skv, and q_start =
    kv_len - sq (bottom-right) under ``causal``, else 0."""
    lens = [min(skv, n) for n in _rows(kv_len, b, skv)]
    starts = _rows(q_start, b, 0) if q_start is not None else [
        (n - sq if causal else 0) for n in lens]
    pairs, seen = 0, 0
    for s0, n in zip(starts, lens):
        if causal:
            pairs += sum(max(0, min(n, s0 + i + 1)) for i in range(sq))
            seen += max(0, min(n, s0 + sq))
        else:
            pairs += sq * n
            seen += n
    return {"pairs": pairs * hq, "q": 2 * b * hq * sq * d, "kv": 2 * seen * hkv * d,
            "row": 4 * b * hq * sq, "kv_all": 2 * b * hkv * skv * d, "d": d}


def flash_fwd_bound(w: dict) -> float:
    """Q, K, V read, O and LSE written; QK^T and PV at the real head dim."""
    return bound(4 * w["d"] * w["pairs"], 2 * w["q"] + 2 * w["kv"] + w["row"])


BWD_FLOPS_PER_PAIR = {"dq": 6, "dkv": 8}  # times d: S, dP and dS K; S, dP, P^T dO and dS^T Q


def flash_bwd_bounds(w: dict):
    """(dq, dk/dv) seconds. dq: reading Q, dO, O, K, V and LSE, writing dq
    and delta; dk/dv: reading Q, dO, K, V, LSE and delta, writing dk and dv
    for every key."""
    ops = {k: n * w["d"] * w["pairs"] for k, n in BWD_FLOPS_PER_PAIR.items()}
    return (bound(ops["dq"], 4 * w["q"] + 2 * w["kv"] + 2 * w["row"]),
            bound(ops["dkv"], 2 * w["q"] + 2 * w["kv"] + 2 * w["row"] + 2 * w["kv_all"]))


def int8_linear_bound(m: int, n: int, k: int) -> float:
    """Weight-only int8 product of m bf16 rows: the int8 weight (n, k), its
    f32 scales, x and y once each; the products at the bf16 rate (the
    weight is widened to bf16 before the tensor cores)."""
    return bound(2 * m * n * k, n * k + 2 * m * k + 4 * n + 2 * m * n)


def decode_attn_bound(b: int, hq: int, hkv: int, s: int, d: int, starts: Sequence[int],
                      kv_len: Sequence[int], cache_bytes: int) -> float:
    """Small-query cache attention: the visible keys' K and V (``cache_bytes``
    an element) plus, for an int8 cache, their two f32 scales, q and O once
    each; QK^T and PV over the visible pairs."""
    w = attention_work(b, hq, hkv, s, max(kv_len), d, True, starts, kv_len)
    keys = w["kv"] // (2 * d)  # (batch row, KV head, key) triples some row sees
    nbytes = 2 * keys * d * cache_bytes + (8 * keys if cache_bytes == 1 else 0) + 2 * w["q"]
    return bound(4 * d * w["pairs"], nbytes)


# Model FLOPs, counted from shapes: two operations a multiply-add, the matrix
# products and attention only (norms, activations and softmax are left out).

def llama_forward_flops(cfg: dict, rows: Iterable[tuple], logits_rows: int) -> float:
    """One forward of the LLaMA over a block: ``rows`` holds (start, new)
    for each batch row (the cache's fill before the block and the row's true
    new tokens); ``logits_rows`` the positions the head is applied to."""
    d, inter, layers = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    heads, hkv = cfg["num_attention_heads"], cfg.get("num_key_value_heads") or cfg[
        "num_attention_heads"]
    hd = d // heads
    proj = d * (heads * hd) * 2 + d * (hkv * hd) * 2 + 3 * d * inter
    lora = 7 * cfg.get("lora_rank", 0) * 2 * (d + inter) if cfg.get("lora_rank") else 0
    tokens = pairs = 0
    for start, new in rows:
        tokens += new
        pairs += sum(start + i + 1 for i in range(new))
    per_layer = 2 * (proj + lora) * tokens + 4 * hd * heads * pairs
    return layers * per_layer + 2 * d * cfg["padded_vocab_size"] * logits_rows


def vit_forward_flops(vit: dict, images: int) -> float:
    """ViT-bigG with attention pooling: the patch convolution, the blocks
    (fused qkv, attention, out projection, MLP), the pool's key projection,
    its cross-attention to ``n_queries`` and the final projection."""
    w, grid = vit["width"], vit["image_size"] // vit["patch_size"]
    t, mlp = grid * grid, int(w * vit["mlp_ratio"])
    e, q = vit["output_dim"], vit["n_queries"]
    conv = 2 * t * w * 3 * vit["patch_size"] ** 2
    blocks = vit["layers"] * (2 * t * (4 * w * w + 2 * w * mlp) + 4 * t * t * w)
    pool = 2 * t * w * e + 2 * q * e * e + 4 * t * e * e + 4 * q * t * e + 2 * q * e * e
    return images * (conv + blocks + pool + 2 * q * e * e)


def resampler_flops(queries: int, keys: int, dim: int, kv_dim: int, n: int) -> float:
    """The Qwen resampler (one cross-attention) over ``n`` inputs of
    ``keys`` tokens."""
    kv_proj = 2 * keys * kv_dim * dim if kv_dim != dim else 0
    return n * (kv_proj + 2 * queries * dim * dim + 4 * keys * dim * dim
                + 4 * queries * keys * dim + 2 * queries * dim * dim)
