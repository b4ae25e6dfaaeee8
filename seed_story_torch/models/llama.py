"""LLaMA-2 with LoRA for inference, in PyTorch; counterpart of
``seed_story_tpu/models/llama.py``.

Module and parameter names follow HF ``LlamaForCausalLM`` with PEFT LoRA
(``model.layers.{i}.self_attn.q_proj.weight``, ``...q_proj.lora_A.weight``),
so ``seed_story_tpu/tools/convert_torch_weights.py`` reads a state dict of
this model. Prefill attention goes through ``ops.attention.mha`` (the CUDA
flash kernel on the card); short query blocks (s <= 8) through
``decode_attention``. The embedding and lm_head keep the padded vocab rows;
logits past ``vocab_size`` are masked to -1e9.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import decode_attention, mha
from ..ops.rope import apply_rope, rope_frequencies


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32066  # 32000 + 66 multimodal tokens
    # Embedding/lm_head rows are padded to this size (None -> next multiple
    # of 128); logits beyond vocab_size are masked.
    padded_vocab_size: Optional[int] = None
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # None -> MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling_type: Optional[str] = None  # None | 'linear' | 'dynamic'
    rope_scaling_factor: float = 1.0
    tie_word_embeddings: bool = False
    lora_rank: int = 0
    lora_alpha: float = 32.0
    lora_dropout: float = 0.05  # training only; inference applies none
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32  # projection / embedding storage

    @property
    def vocab_padded(self) -> int:
        if self.padded_vocab_size is not None:
            return self.padded_vocab_size
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(vocab_size=32066, hidden_size=128, intermediate_size=352,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=512)
        base.update(kw)
        return LlamaConfig(**base)


@dataclasses.dataclass
class KVCache:
    """Fixed-capacity KV cache: one (B, kv_heads, capacity, head_dim) pair of
    buffers per layer, plus each row's fill level as host integers.

    Unlike the JAX cache (an immutable pytree returned anew by every call),
    the forward writes the new keys and values into these buffers IN PLACE
    and advances ``length``; the buffers are allocated once per generate
    call."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    length: List[int]

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, capacity: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> "KVCache":
        shape = (batch, cfg.kv_heads, capacity, cfg.head_dim)
        n = cfg.num_hidden_layers
        return cls(k=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)],
                   v=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(n)],
                   length=[0] * batch)

    @property
    def capacity(self) -> int:
        return self.k[0].shape[2]


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5, dtype=torch.bfloat16):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x):
        xf = x.float()
        xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(self.dtype)


class LoRADense(nn.Module):
    """y = x W^T (+ b) + (alpha / r) * (x A^T) B^T, all in ``dtype``.
    ``weight`` is (out, in) like ``nn.Linear``; the adapter is the PEFT pair
    ``lora_A`` (r, in) and ``lora_B`` (out, r)."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = False,
                 lora_rank: int = 0, lora_alpha: float = 32.0,
                 dtype=torch.bfloat16, param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=param_dtype))
                     if bias else None)
        self.lora_rank = lora_rank
        if lora_rank > 0:
            self.scaling = lora_alpha / lora_rank
            self.lora_A = nn.Linear(in_features, lora_rank, bias=False, dtype=param_dtype)
            self.lora_B = nn.Linear(lora_rank, out_features, bias=False, dtype=param_dtype)

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.linear(x, self.weight.to(dt), bias)
        if self.lora_rank > 0:
            xa = F.linear(x, self.lora_A.weight.to(dt))
            y = y + self.scaling * F.linear(xa, self.lora_B.weight.to(dt))
        return y


def _proj(cfg: LlamaConfig, n_in: int, n_out: int) -> LoRADense:
    return LoRADense(n_in, n_out, lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                     dtype=cfg.dtype, param_dtype=cfg.param_dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        h, hkv, hd, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim, cfg.hidden_size
        self.q_proj = _proj(cfg, d, h * hd)
        self.k_proj = _proj(cfg, d, hkv * hd)
        self.v_proj = _proj(cfg, d, hkv * hd)
        self.o_proj = _proj(cfg, h * hd, d)

    def forward(self, x, cos, sin, *, layer_idx: int, cache: Optional[KVCache],
                start: torch.Tensor, kv_len: Optional[torch.Tensor]):
        """x: (B, S, D). With a cache, the new K/V land at each row's fill
        level ``start`` (B,) and attention spans the buffer's valid prefix."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
        q = self.q_proj(x).view(b, s, h, hd).transpose(1, 2)
        k = self.k_proj(x).view(b, s, hkv, hd).transpose(1, 2)
        v = self.v_proj(x).view(b, s, hkv, hd).transpose(1, 2)
        q, k = apply_rope(q, k, cos, sin)

        if cache is None:
            out = mha(q, k, v, causal=True, q_start=0, kv_len=kv_len)
        else:
            k_buf, v_buf = cache.k[layer_idx], cache.v[layer_idx]
            for row, st in enumerate(cache.length):
                k_buf[row, :, st:st + s] = k[row]
                v_buf[row, :, st:st + s] = v[row]
            end = start + s
            q = q.to(cfg.dtype)
            if s <= 8:
                # short query block: plain matvecs over the valid prefix only
                limit = max(cache.length) + s
                out = decode_attention(q, k_buf[:, :, :limit], v_buf[:, :, :limit],
                                       kv_len=end, q_start=start)
            else:
                out = mha(q, k_buf.to(cfg.dtype), v_buf.to(cfg.dtype), causal=True,
                          q_start=start, kv_len=end)
        out = out.transpose(1, 2).reshape(b, s, h * hd)
        return self.o_proj(out)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = _proj(cfg, cfg.hidden_size, cfg.intermediate_size)
        self.up_proj = _proj(cfg, cfg.hidden_size, cfg.intermediate_size)
        self.down_proj = _proj(cfg, cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, cos, sin, **attn_kw):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, **attn_kw)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_padded, cfg.hidden_size, dtype=cfg.param_dtype)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)

    def embed(self, input_ids):
        return self.embed_tokens(input_ids).to(self.cfg.dtype)

    def forward(self, input_ids=None, *, inputs_embeds=None, cache: Optional[KVCache] = None,
                attention_mask: Optional[torch.Tensor] = None):
        """Returns the final-norm hidden states (B, S, D). With a cache, the
        call appends S tokens to every row and advances ``cache.length``.
        Without one, ``attention_mask`` (B, S) marks suffix padding."""
        cfg = self.cfg
        x = (self.embed(input_ids) if inputs_embeds is None else inputs_embeds).to(cfg.dtype)
        b, s, _ = x.shape
        if cache is not None:
            if max(cache.length) + s > cache.capacity:
                raise ValueError(f"KV cache overflow: {max(cache.length)} + {s} tokens "
                                 f"> capacity {cache.capacity}")
            start_host = cache.length
        else:
            start_host = [0] * b
        start = torch.tensor(start_host, dtype=torch.int32, device=x.device)
        kv_len = None
        if cache is None and attention_mask is not None:
            kv_len = attention_mask.to(torch.int32).sum(dim=-1)
        positions = start[:, None] + torch.arange(s, device=x.device)[None, :]
        cos, sin = rope_frequencies(
            cfg.head_dim, positions, base=cfg.rope_theta, scaling_type=cfg.rope_scaling_type,
            scaling_factor=cfg.rope_scaling_factor,
            max_position_embeddings=cfg.max_position_embeddings,
            seq_len=float(max(start_host) + s))
        for i, layer in enumerate(self.layers):
            x = layer(x, cos, sin, layer_idx=i, cache=cache, start=start, kv_len=kv_len)
        if cache is not None:
            cache.length = [n + s for n in cache.length]
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg)
        self.lm_head = LoRADense(cfg.hidden_size, cfg.vocab_padded, dtype=cfg.dtype,
                                 param_dtype=cfg.param_dtype)

    def forward(self, input_ids=None, *, inputs_embeds=None, cache: Optional[KVCache] = None,
                attention_mask: Optional[torch.Tensor] = None,
                logits_indices: Optional[torch.Tensor] = None):
        """``logits_indices`` (B,): lm_head only at those positions -> (B, 1, V).
        Returns {"logits", "hidden_states", "cache"}."""
        hidden = self.model(input_ids, inputs_embeds=inputs_embeds, cache=cache,
                            attention_mask=attention_mask)
        head_in = hidden
        if logits_indices is not None:
            rows = torch.arange(hidden.shape[0], device=hidden.device)
            head_in = hidden[rows, logits_indices.to(hidden.device)][:, None]
        logits = self.lm_head(head_in)
        cfg = self.cfg
        if cfg.vocab_padded != cfg.vocab_size:
            pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e9)
        return {"logits": logits, "hidden_states": hidden, "cache": cache}

    def embed(self, input_ids):
        return self.model.embed(input_ids)
