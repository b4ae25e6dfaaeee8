"""Tensor-parallel decode in one process; the counterpart of the JAX
package's ``StoryGenerator(mesh=...)`` with the ``fsdp_tp`` preset
(``seed_story_tpu/decode/generate.py:106-139``).

The JAX flow is single-controller: one program decodes over the first
``decode_tp`` devices, and the rest host de-tokenizer replicas
(``pipelines/serving.py::split_devices``). Here :func:`shard_llama_` splits
the agent's ``LlamaForCausalLM`` in place and keeps shard r of every layer
on device r; the model's own forward (``LlamaModel``, ``LlamaDecoderLayer``,
``LlamaForCausalLM``) runs unchanged over three stand-ins:

  * :class:`ParallelAttention` and :class:`ParallelMLP` in place of each
    layer's ``self_attn`` and ``mlp``: column-parallel q / k / v and gate /
    up, row-parallel o and down (``parallel/sharding.py::split_dense``, the
    split fsdp_tp training uses); each shard's partial output is added onto
    the first device in shard order;
  * :class:`ParallelHead` in place of ``lm_head``, split over
    ``vocab_padded`` (column-parallel), its logits joined on the first
    device;
  * the KV cache split by KV heads (:class:`ShardedKVCache`; int8 rows and
    scales or bf16 alike).

Each shard runs the port's kernels on its local tensors: kernel A / C on
N / tp weight rows (or K / tp columns), the cache attention (kernel B) and
the flash forward on H / tp heads. The embedding, the norms and the RoPE
tables stay whole on the first device. The device list may name one device
more than once (the CPU tests, or one card standing in for tp of them).
Partial sums change the summation order, so tokens may part from the
``tp = 1`` ones at near-ties (``PERF.md`` §2's rule), never by design.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..models.llama import KVCache, LlamaAttention, LlamaConfig, LlamaForCausalLM, LlamaMLP
from ..parallel.sharding import TP_STYLES, split_dense


class ShardedKVCache:
    """One :class:`KVCache` a shard, each on its device with kv_heads / tp
    heads; ``length`` reads and sets every shard's."""

    def __init__(self, shards: List[KVCache]):
        self.shards = shards

    @classmethod
    def create(cls, cfg: LlamaConfig, devices: Sequence, batch: int, capacity: int,
               dtype: Optional[torch.dtype] = None) -> "ShardedKVCache":
        """A cache of ``capacity`` slots for ``batch`` rows, split by KV
        heads over ``devices``."""
        shard_cfg = dataclasses.replace(cfg, num_key_value_heads=cfg.kv_heads // len(devices))
        return cls([KVCache.create(shard_cfg, batch, capacity, dtype=dtype or cfg.dtype,
                                   device=d) for d in devices])

    @property
    def length(self) -> List[int]:
        return self.shards[0].length

    @length.setter
    def length(self, value) -> None:
        for shard in self.shards:
            shard.length = list(value)

    @property
    def capacity(self) -> int:
        return self.shards[0].capacity


class _Shards(nn.Module):
    """Module r of ``shards`` on ``devices[r]``; outputs join on the device
    of the input."""

    def __init__(self, shards: Sequence[nn.Module], devices: Sequence[torch.device]):
        super().__init__()
        self.shards = nn.ModuleList(shards)
        self.devices = list(devices)

    @staticmethod
    def _sum(parts: List[torch.Tensor], device) -> torch.Tensor:
        out = parts[0].to(device)
        for p in parts[1:]:
            out = out + p.to(device)
        return out


class ParallelAttention(_Shards):
    """``LlamaAttention``'s call over head shards; ``cache`` is a
    :class:`ShardedKVCache`."""

    def forward(self, x, cos, sin, *, layer_idx: int, cache: Optional[ShardedKVCache],
                start: torch.Tensor, kv_len: Optional[torch.Tensor],
                dropout_seed: Optional[int] = None):
        parts = []
        for r, (attn, d) in enumerate(zip(self.shards, self.devices)):
            parts.append(attn(x.to(d), cos.to(d), sin.to(d), layer_idx=layer_idx,
                              cache=None if cache is None else cache.shards[r],
                              start=start.to(d), kv_len=None if kv_len is None else kv_len.to(d),
                              dropout_seed=dropout_seed))
        return self._sum(parts, x.device)


class ParallelMLP(_Shards):
    """``LlamaMLP``'s call over intermediate-size shards."""

    def forward(self, x, dropout_seed: Optional[int] = None):
        return self._sum([mlp(x.to(d), dropout_seed) for mlp, d in zip(self.shards, self.devices)],
                         x.device)


class ParallelHead(_Shards):
    """``lm_head``'s call over vocabulary shards, joined in order."""

    def forward(self, x, dropout_seed: Optional[int] = None):
        return torch.cat([head(x.to(d)).to(x.device) for head, d in zip(self.shards, self.devices)],
                         dim=-1)


def _shard_module(module: nn.Module, cls, cfg: LlamaConfig, rank: int, tp: int, device):
    """A ``cls`` (LlamaAttention / LlamaMLP) whose projections are shard
    ``rank`` of ``module``'s, on ``device``."""
    with torch.device("meta"):
        shard = cls(cfg)
    for name, child in module.named_children():
        setattr(shard, name, split_dense(child, TP_STYLES[name], rank, tp, device=device))
    return shard.eval()


def shard_llama_(llm: LlamaForCausalLM, devices: Sequence) -> LlamaForCausalLM:
    """In place: every layer's attention and MLP and the ``lm_head`` of a
    filled ``llm`` become their shards over ``devices`` (the originals'
    projections are sliced and freed); the embedding and norms move to the
    first device. Returns ``llm``."""
    cfg, devices = llm.cfg, [torch.device(d) for d in devices]
    tp, dev0 = len(devices), devices[0]
    for what, n in (("attention heads", cfg.num_attention_heads),
                    ("KV heads", cfg.kv_heads), ("intermediate_size", cfg.intermediate_size),
                    ("vocab_padded", cfg.vocab_padded)):
        if n % tp:
            raise ValueError(f"decode_tp {tp}: {what} ({n}) do not divide it")
    llm.model.embed_tokens.to(dev0)
    llm.model.norm.to(dev0)
    for layer in llm.model.layers:
        layer.input_layernorm.to(dev0)
        layer.post_attention_layernorm.to(dev0)
        layer.self_attn = ParallelAttention(
            [_shard_module(layer.self_attn, LlamaAttention, cfg, r, tp, d)
             for r, d in enumerate(devices)], devices)
        layer.mlp = ParallelMLP([_shard_module(layer.mlp, LlamaMLP, cfg, r, tp, d)
                                 for r, d in enumerate(devices)], devices)
    llm.lm_head = ParallelHead([split_dense(llm.lm_head, "col", r, tp, device=d)
                                for r, d in enumerate(devices)], devices)
    return llm.eval()
