"""The yardstick's arithmetic for the mixture-of-experts story cell
(``kexaone_story_b8``): the bounds of the grouped int8 expert kernel and of
kernel B with a window, and the model FLOPs of a K-EXAONE forward, counted
from shapes and the routing the hooks saw. The peaks and ``bound`` are
``roofline.py``'s."""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from perfbench.roofline import bound, int8_linear_bound


def grouped_int8_bound(hit_experts: int, pairs: int, x_rows: int, n: int, k: int) -> float:
    """One launch of the grouped expert kernel: the int8 weights (n, k) and
    f32 scales of the experts some pair hit, the ``x_rows`` distinct bf16
    input rows the pairs read and the pairs' bf16 output rows, once each;
    2 n k FLOPs a pair at the bf16 rate (the weights are widened to bf16
    before the tensor cores)."""
    return bound(2 * pairs * n * k, hit_experts * (n * k + 4 * n) + 2 * x_rows * k + 2 * pairs * n)


def decode_attn_window_bound(b: int, hq: int, hkv: int, s: int, d: int, starts: Sequence[int],
                             window: int, cache_bytes: int) -> float:
    """Kernel B over a verify block of ``s`` queries a row at ``starts``,
    each query at position p seeing keys max(0, p + 1 - window) .. p (all
    keys 0 .. p without a window): the keys some query of a row sees, K and V
    at ``cache_bytes`` an element plus an int8 cache's two f32 scales, q read
    and O written once; QK^T and PV over the visible pairs."""
    pairs = keys = 0
    for st in starts:
        lo = (lambda p: max(0, p + 1 - window)) if window else (lambda p: 0)
        pairs += sum(st + i + 1 - lo(st + i) for i in range(s))
        keys += st + s - lo(st)
    nbytes = (2 * keys * hkv * d * cache_bytes + (8 * keys * hkv if cache_bytes == 1 else 0)
              + 2 * 2 * b * hq * s * d)
    return bound(4 * d * pairs * hq, nbytes)


def kexaone_forward_flops(c: dict, rows: Iterable[tuple], logits_rows: int) -> float:
    """One forward over a block, every matrix product but the routed
    experts' (:func:`expert_pair_flops` counts those from the routing):
    ``rows`` holds (start, new) for each batch row; attention pairs per
    layer from its window (``sliding_windows``, 0 global); ``logits_rows``
    the positions the head is applied to."""
    d, h, hkv, hd = (c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"],
                     c["head_dim"])
    r, n_layers = c["lora_rank"], c["num_hidden_layers"]
    attn = 2 * d * h * hd + 2 * d * hkv * hd
    attn_lora = r * (2 * d + 2 * h * hd + 2 * (d + hkv * hd))  # A and B of q, k, v, o
    rows = list(rows)
    tokens = sum(n for _, n in rows)
    total = 2 * d * c["padded_vocab_size"] * logits_rows
    for layer in range(n_layers):
        width = (c["intermediate_size"] if layer < c["first_k_dense_replace"]
                 else c["moe_intermediate_size"] * c["num_shared_experts"])
        ffn = 3 * d * width + 3 * r * (d + width)
        router = 0 if layer < c["first_k_dense_replace"] else d * c["router_experts"]
        window = c["sliding_windows"][layer]
        pairs = 0
        for start, new in rows:
            for i in range(new):
                p = start + i
                pairs += p + 1 - (max(0, p + 1 - window) if window else 0)
        total += 2 * (attn + attn_lora + ffn + router) * tokens + 4 * hd * h * pairs
    return total


def expert_pair_flops(c: dict) -> float:
    """A routed (token, expert) pair's SwiGLU: gate, up and down."""
    return 2 * 3 * c["hidden_size"] * c["moe_intermediate_size"]


def grouped_launch_bounds(records: list) -> list:
    """The bound of each grouped kernel launch of the hooks' expert calls
    (``drivers/story_lockstep_moe.py``: a call's dispatch, device tensors
    read here once): two launches a grouped call, gate and up (2I x D, x
    the tokens with a pair held here) and down (D x I, x the pairs)."""
    grouped = [r for r in records if r["grouped"]]
    by_len = {}
    for r in grouped:
        by_len.setdefault(r["order"].shape[0], []).append(r)
    bounds = []
    for group in by_len.values():
        orders = torch.stack([r["order"] for r in group]).cpu().numpy()
        offsets = torch.stack([r["offsets"] for r in group]).cpu().numpy()
        for r, order, off in zip(group, orders, offsets):
            pairs, hit = int(off[-1]), int(np.count_nonzero(np.diff(off)))
            tokens = len(np.unique(order[:pairs] // r["top_k"]))
            d, i = r["d"], r["i"]
            bounds += [grouped_int8_bound(hit, pairs, tokens, 2 * i, d),
                       grouped_int8_bound(hit, pairs, pairs, d, i)]
    return bounds


def int8_gemm_bounds(linear_records: list, expert_records: list) -> list:
    """The bound of each kernel C launch (more than 32 rows): the hooks'
    int8 projections (m, n, k), and, for each expert call that loops over
    the held experts (a prefill: gate and up, then down, for each expert
    with more than 32 pairs), its experts' pair counts. A launch's bound is
    ``roofline.int8_linear_bound``: the weight, its scales, x and y once
    each, the products at the bf16 rate."""
    bounds = [int8_linear_bound(r["m"], r["n"], r["k"]) for r in linear_records if r["m"] > 32]
    looped = [r for r in expert_records if not r["grouped"]]
    if looped:
        counts = np.diff(torch.stack([r["offsets"] for r in looped]).cpu().numpy(), axis=1)
        for r, per_expert in zip(looped, counts):
            d, i = r["d"], r["i"]
            for m in (int(c) for c in per_expert if c > 32):
                bounds += [int8_linear_bound(m, 2 * i, d), int8_linear_bound(m, d, i)]
    return bounds
