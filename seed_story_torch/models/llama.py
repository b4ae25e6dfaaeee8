"""LLaMA-2 with LoRA in PyTorch, for inference and training; counterpart of
``seed_story_tpu/models/llama.py``.

Module and parameter names follow HF ``LlamaForCausalLM`` with PEFT LoRA
(``model.layers.{i}.self_attn.q_proj.weight``, ``...q_proj.lora_A.weight``),
so ``seed_story_tpu/tools/convert_torch_weights.py`` reads a state dict of
this model. Prefill and training attention go through ``ops.attention.mha``
(the CUDA flash kernels on the card, differentiable); short query blocks
(s <= 8) through ``decode_attention``. The embedding and lm_head keep the
padded vocab rows; logits past ``vocab_size`` are masked to -1e9.

int8 surface (inference): ``quantize_base`` stores the seven projection
weights as int8 with per-output-channel scales (``quantize_llama_``
converts a float model in place); the base product goes through
``ops.int8_linear``. ``quantize_kv`` keeps the KV cache as int8 rows with
per-(batch, head, token) scales: decode applies them after the products
(``decode_attention``), prefill dequantizes the cache's valid prefix once
and runs ``mha``.

Training surface: LoRA dropout on the adapter input with masks drawn from
(step seed, layer, projection), so a rematerialized layer draws the same
masks again; per-layer ``remat``; ``hidden_states`` + ``chunked_loss``
(next-token CE in sequence chunks, never the (B, S, V) logits);
``lora_trainable_mask``.

Under a mesh (``parallel/sharding.py``) a layer may be a shard: a
projection's Megatron split (``LoRADense.tp``); the vocabulary over
``model`` (``embed_tokens`` by rows: :meth:`LlamaModel.embed` adds the
shards' rows; ``lm_head`` by columns: the logits and the cross-entropy
are taken on vocabulary shards, :func:`vocab_parallel_log_likelihood`);
an int8 base weight over ``data`` (``LoRADense.data_shard``: the product
gathers it).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import decode_attention, mha
from ..ops.int8_linear import int8_linear, int8_linear_gathered
from ..ops.rope import apply_rope, rope_frequencies
from ..parallel.collectives import bound_group, copy_to_group, global_mean, reduce_from_group
from ..utils import tracing

if TYPE_CHECKING:
    from .moe import MoEConfig

# query blocks of at most this many positions a row (decode, speculative
# verify) take decode_attention, and a mixture of experts' grouped kernel
SHORT_BLOCK = 8


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The decoder's shape and serving precision. The fields after
    ``param_dtype`` describe blocks other than LLaMA's (EXAONE 4 / K-EXAONE's);
    at their defaults a layer is LLaMA's, with the same parameters and the
    same device work:

    - ``head_size``: the attention heads' width where it is not
      ``hidden_size / num_attention_heads`` (q is heads x head_size wide);
    - ``sliding_windows``: one window a layer, 0 for a global layer, empty
      for all global. A windowed layer's query at position i sees the keys j
      with i - window < j <= i (HF's ``sliding_window``: the window counts
      the query's own key); every layer keeps the cache's one capacity;
    - ``nope_global``: RoPE in the windowed layers only, no position
      encoding in the global ones (EXAONE 4's NoPE global layers);
    - ``qk_norm``: an RMSNorm over each head's channels of q and of k
      (``q_norm`` / ``k_norm``), before RoPE;
    - ``post_norms``: the block is h = x + norm_pa(attn(x)), y = h +
      norm_pf(ffn(h)), with no norm before a sublayer (``post_attention_
      layernorm`` / ``post_feedforward_layernorm``, no ``input_layernorm``);
    - ``moe`` / ``first_k_dense_replace``: layers from
      ``first_k_dense_replace`` on take the mixture of experts of
      ``models/moe.py`` in place of the dense SwiGLU (``intermediate_size``
      stays the dense layers' width)."""
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
    # rematerialize each decoder layer in the backward (no-cache path only)
    remat: bool = False
    # training CE in sequence chunks of this size (0 = the whole sequence)
    ce_chunk_size: int = 0
    # weight-only int8 for the 7 projections (per-output-channel scales);
    # LoRA, norms, embeddings and lm_head stay in param_dtype
    quantize_base: bool = False
    # int8 KV cache with per-(batch, head, token) scales
    quantize_kv: bool = False
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    param_dtype: torch.dtype = torch.float32  # projection / embedding storage
    head_size: Optional[int] = None
    sliding_windows: Tuple[int, ...] = ()
    nope_global: bool = False
    qk_norm: bool = False
    post_norms: bool = False
    moe: Optional["MoEConfig"] = None
    first_k_dense_replace: int = 0

    def window(self, layer: int) -> int:
        """The layer's sliding window (0: global)."""
        return self.sliding_windows[layer] if self.sliding_windows else 0

    def uses_rope(self, layer: int) -> bool:
        return not (self.nope_global and self.window(layer) == 0)

    def is_moe(self, layer: int) -> bool:
        return self.moe is not None and layer >= self.first_k_dense_replace

    @property
    def vocab_padded(self) -> int:
        if self.padded_vocab_size is not None:
            return self.padded_vocab_size
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def head_dim(self) -> int:
        return self.head_size or self.hidden_size // self.num_attention_heads

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
    buffers per layer, plus each row's fill level as host integers. In int8
    mode (``quantized``) k/v hold int8 rows and ``k_scale`` / ``v_scale``
    one f32 (B, kv_heads, capacity) buffer per layer.

    Unlike the JAX cache (an immutable pytree returned anew by every call),
    the forward writes the new keys and values into these buffers IN PLACE
    and advances ``length``; the buffers are allocated once per cache."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    length: List[int]
    k_scale: Optional[List[torch.Tensor]] = None
    v_scale: Optional[List[torch.Tensor]] = None

    @classmethod
    def create(cls, cfg: LlamaConfig, batch: int, capacity: int,
               dtype: torch.dtype = torch.bfloat16, device=None,
               quantized: Optional[bool] = None) -> "KVCache":
        """``quantized`` None follows ``cfg.quantize_kv``."""
        if quantized is None:
            quantized = cfg.quantize_kv
        shape = (batch, cfg.kv_heads, capacity, cfg.head_dim)

        def buffers(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(cfg.num_hidden_layers)]

        if not quantized:
            return cls(k=buffers(shape, dtype), v=buffers(shape, dtype), length=[0] * batch)
        return cls(k=buffers(shape, torch.int8), v=buffers(shape, torch.int8),
                   length=[0] * batch, k_scale=buffers(shape[:3], torch.float32),
                   v_scale=buffers(shape[:3], torch.float32))

    @property
    def capacity(self) -> int:
        return self.k[0].shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def quantize_kv_rows(x: torch.Tensor):
    """(..., D) -> int8 rows and the per-row symmetric scale max|x| / 127
    (f32); the division uses the scale floored at 1e-8, the returned scale
    is not floored (as the JAX ``quantize_kv_rows``)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = scale.clamp_min(1e-8)
    q = torch.round(xf / safe[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor):
    """(out, ...) float weight (a Linear's (out, in), a Conv2d's OIHW) ->
    int8 weight and per-output-channel f32 scale max|w| / 127 over every
    other axis, floored at 1e-8 (the JAX ``quantize_llama_params`` and
    ``quantize_unet_params`` on the flax kernel, whose output axis is last).
    The bits are the same on every device: the divisor is a tensor, since
    CUDA turns a division by a Python number into a product with its
    reciprocal, which rounds otherwise."""
    wf = w.float()
    amax = wf.abs().flatten(1).amax(dim=1)
    scale = (amax / amax.new_full((), 127.0)).clamp_min(1e-8)
    q = torch.round(wf / scale.view(-1, *[1] * (w.dim() - 1))).clamp(-127, 127)
    return q.to(torch.int8), scale


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


def derive_seed(*parts) -> int:
    """A 63-bit seed from ints and strings: the same on every run and host,
    and unrelated for different parts."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def lora_dropout(x: torch.Tensor, rate: float, seed: int,
                 cols: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Inverted dropout (kept entries scaled by 1 / (1 - rate)). Row g of the
    global batch (x's leading axis) draws its mask from a generator seeded
    with ``derive_seed(seed, g)`` on x's device, so the same seed gives the
    same mask again, and a rank draws only its own rows.

    Inside a step bound to a data-parallel group of n ranks
    (``parallel.collectives.data_parallel``) x holds rows [r b, (r + 1) b)
    of the global batch of n b rows; a row-parallel shard's x holds columns
    ``cols`` = (index, count) of the last axis, and its rows draw every
    column (``count`` times its own) and keep theirs. So a sharded step
    draws what the one-process step on the global batch draws."""
    group = bound_group("data")
    first = 0 if group is None else dist.get_rank(group) * x.shape[0]
    col, ncols = cols
    row_shape = [*x.shape[1:-1], x.shape[-1] * ncols]
    gen = torch.Generator(device=x.device)
    keep = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    for i in range(x.shape[0]):
        gen.manual_seed(derive_seed(seed, first + i))
        row = torch.rand(row_shape, generator=gen, device=x.device) >= rate
        keep[i] = row.narrow(-1, col * x.shape[-1], x.shape[-1])
    return torch.where(keep, x / (1.0 - rate), 0.0)


class LoRADense(nn.Module):
    """y = x W^T (+ b) + (alpha / r) * (dropout(x) A^T) B^T, all in ``dtype``.
    ``weight`` is (out, in) like ``nn.Linear``; the adapter is the PEFT pair
    ``lora_A`` (r, in) and ``lora_B`` (out, r). Dropout acts on the adapter's
    input only, in training mode with a ``dropout_seed``; its mask comes from
    (dropout_seed, ``dropout_key``), and ``LlamaModel`` names each projection's
    key by layer and module path.

    With ``quantize`` (or after :meth:`quantize_`) ``weight`` is int8 (out,
    in) with a per-output-channel f32 ``weight_scale``, both frozen, and the
    base product is ``int8_linear``: y = bf16(x W^T) * bf16(scale) in
    ``dtype``, then the bias, then the LoRA term (the JAX rounding order).

    ``tp`` (a ``parallel.sharding.TPSpec`` with a process group, set by
    ``split_dense``) makes the module one Megatron shard: a column shard
    takes the whole x, its gradient to x summed over the group, and the
    LoRA intermediate x A^T whole (its gradient summed, so ``lora_A``'s is
    whole on every rank); a row shard (which has no bias) sums its partial
    x_r W_r^T and x_r A_r^T over the group, the latter before ``lora_B``.

    ``data_shard`` (a ``parallel.sharding.DataShard``, set by
    ``shard_int8_base_``) means the int8 weight and its scale are this
    rank's row slices over a data group; the product gathers them
    (``int8_linear_gathered``)."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = False,
                 lora_rank: int = 0, lora_alpha: float = 32.0, lora_dropout: float = 0.0,
                 quantize: bool = False, dtype=torch.bfloat16, param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        if quantize:
            self.weight = nn.Parameter(torch.zeros(out_features, in_features, dtype=torch.int8),
                                       requires_grad=False)
            self.weight_scale = nn.Parameter(torch.ones(out_features, dtype=torch.float32),
                                             requires_grad=False)
        else:
            self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=param_dtype))
                     if bias else None)
        self.lora_rank = lora_rank
        self.lora_dropout = lora_dropout
        self.dropout_key = ""
        self.tp = None
        self.data_shard = None
        if lora_rank > 0:
            self.scaling = lora_alpha / lora_rank
            self.lora_A = nn.Linear(in_features, lora_rank, bias=False, dtype=param_dtype)
            self.lora_B = nn.Linear(lora_rank, out_features, bias=False, dtype=param_dtype)

    @property
    def quantized(self) -> bool:
        return self.weight.dtype == torch.int8

    @torch.no_grad()
    def quantize_(self) -> "LoRADense":
        """In place: the float weight becomes int8 with per-output-channel
        scales (:func:`quantize_weight`); the float copy is freed."""
        if not self.quantized:
            q, scale = quantize_weight(self.weight)
            self.weight = nn.Parameter(q, requires_grad=False)
            self.weight_scale = nn.Parameter(scale, requires_grad=False)
        return self

    def forward(self, x, dropout_seed: Optional[int] = None):
        dt = self.dtype
        tp = self.tp if self.tp is not None and self.tp.group is not None else None
        col, row = tp is not None and tp.style == "col", tp is not None and tp.style == "row"
        bias = None if self.bias is None else self.bias.to(dt)
        xb = copy_to_group(x, tp.group) if col else x
        if self.quantized:
            shard = self.data_shard
            y = (int8_linear(xb, self.weight, self.weight_scale) if shard is None else
                 int8_linear_gathered(xb, self.weight, self.weight_scale, shard.rows,
                                      shard.group))
            if bias is not None:
                y = y + bias
        else:
            y = F.linear(xb, self.weight.to(dt), bias)
        if row:  # a row shard has no bias (split_dense)
            y = reduce_from_group(y, tp.group)
        if self.lora_rank > 0:
            xl = x
            if self.training and self.lora_dropout > 0 and dropout_seed is not None:
                xl = lora_dropout(x, self.lora_dropout,
                                  derive_seed(dropout_seed, self.dropout_key),
                                  cols=(tp.rank, tp.size) if row else (0, 1))
            xa = F.linear(xl, self.lora_A.weight.to(dt))
            if tp is not None:
                xa = copy_to_group(xa, tp.group) if col else reduce_from_group(xa, tp.group)
            y = y + self.scaling * F.linear(xa, self.lora_B.weight.to(dt))
        return y


def _proj(cfg: LlamaConfig, n_in: int, n_out: int) -> LoRADense:
    return LoRADense(n_in, n_out, lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                     lora_dropout=cfg.lora_dropout, quantize=cfg.quantize_base,
                     dtype=cfg.dtype, param_dtype=cfg.param_dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, layer_idx: int = 0):
        super().__init__()
        self.cfg = cfg
        h, hkv, hd, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim, cfg.hidden_size
        self.window = cfg.window(layer_idx)
        self.rope = cfg.uses_rope(layer_idx)
        self.q_proj = _proj(cfg, d, h * hd)
        self.k_proj = _proj(cfg, d, hkv * hd)
        self.v_proj = _proj(cfg, d, hkv * hd)
        self.o_proj = _proj(cfg, h * hd, d)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.rms_norm_eps, cfg.dtype)
            self.k_norm = RMSNorm(hd, cfg.rms_norm_eps, cfg.dtype)

    def forward(self, x, cos, sin, *, layer_idx: int, cache: Optional[KVCache],
                start: torch.Tensor, kv_len: Optional[torch.Tensor],
                dropout_seed: Optional[int] = None):
        """x: (B, S, D). With a cache, the new K/V land at each row's fill
        level ``start`` (B,) and attention spans the buffer's valid prefix:
        row r sees ``kv_len[r]`` keys (``start + S``, or ``start`` plus the
        row's true length of a right-padded block), and the padding's K/V
        lands beyond it. A windowed layer passes its window to the attention,
        which reads only the keys inside it. Under a profiler the quantize
        and the writes are the span ``llm.kv_write`` (``utils/tracing.py``)."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim  # heads follow the projections (a tensor-parallel shard has H / tp)
        q = self.q_proj(x, dropout_seed).view(b, s, -1, hd).transpose(1, 2)
        k = self.k_proj(x, dropout_seed).view(b, s, -1, hd).transpose(1, 2)
        v = self.v_proj(x, dropout_seed).view(b, s, -1, hd).transpose(1, 2)
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if self.rope:
            q, k = apply_rope(q, k, cos, sin)

        if cache is None:
            out = mha(q, k, v, causal=True, q_start=0, kv_len=kv_len, window=self.window)
        else:
            k_buf, v_buf = cache.k[layer_idx], cache.v[layer_idx]
            ks_buf = vs_buf = None
            with tracing.span("llm.kv_write"):
                if cache.quantized:
                    ks_buf, vs_buf = cache.k_scale[layer_idx], cache.v_scale[layer_idx]
                    (k, k_sc), (v, v_sc) = quantize_kv_rows(k), quantize_kv_rows(v)
                    writes = ((k_buf, k), (v_buf, v), (ks_buf, k_sc), (vs_buf, v_sc))
                else:
                    writes = ((k_buf, k), (v_buf, v))
                for row, st in enumerate(cache.length):
                    for buf, new in writes:
                        buf[row, :, st:st + s] = new[row]
            end = kv_len
            q = q.to(cfg.dtype)
            limit = max(cache.length) + s  # attention reads the valid prefix only
            k_buf, v_buf = k_buf[:, :, :limit], v_buf[:, :, :limit]
            if cache.quantized:
                ks_buf, vs_buf = ks_buf[:, :, :limit], vs_buf[:, :, :limit]
            if s <= SHORT_BLOCK:
                # short query block: the int8 scales apply after the products
                out = decode_attention(q, k_buf, v_buf, kv_len=end, q_start=start,
                                       k_scale=ks_buf, v_scale=vs_buf, window=self.window)
            else:
                if cache.quantized:  # prefill dequantizes the prefix once
                    k_buf = k_buf.to(cfg.dtype) * ks_buf[..., None].to(cfg.dtype)
                    v_buf = v_buf.to(cfg.dtype) * vs_buf[..., None].to(cfg.dtype)
                out = mha(q, k_buf.to(cfg.dtype), v_buf.to(cfg.dtype), causal=True,
                          q_start=start, kv_len=end, window=self.window)
        out = out.transpose(1, 2).reshape(b, s, -1)
        return self.o_proj(out, dropout_seed)


class LlamaMLP(nn.Module):
    """The SwiGLU, ``width`` wide (None: ``cfg.intermediate_size``)."""

    def __init__(self, cfg: LlamaConfig, width: Optional[int] = None):
        super().__init__()
        width = width or cfg.intermediate_size
        self.gate_proj = _proj(cfg, cfg.hidden_size, width)
        self.up_proj = _proj(cfg, cfg.hidden_size, width)
        self.down_proj = _proj(cfg, width, cfg.hidden_size)

    def forward(self, x, dropout_seed: Optional[int] = None):
        h = F.silu(self.gate_proj(x, dropout_seed)) * self.up_proj(x, dropout_seed)
        return self.down_proj(h, dropout_seed)


class LlamaDecoderLayer(nn.Module):
    """Layer ``layer_idx`` of the stack: LLaMA's pre-norm block, or with
    ``cfg.post_norms`` the post-norm one, with the layer's window, RoPE and
    FFN (dense, or ``models/moe.py``'s ``MoE``) as the configuration gives
    them (:class:`LlamaConfig`)."""

    def __init__(self, cfg: LlamaConfig, layer_idx: int = 0):
        super().__init__()
        self.post_norms = cfg.post_norms

        def norm():
            return RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)

        if not cfg.post_norms:
            self.input_layernorm = norm()
        self.self_attn = LlamaAttention(cfg, layer_idx)
        self.post_attention_layernorm = norm()
        if cfg.post_norms:
            self.post_feedforward_layernorm = norm()
        if cfg.is_moe(layer_idx):
            from .moe import MoE

            self.mlp = MoE(cfg)
        else:
            self.mlp = LlamaMLP(cfg)

    def forward(self, x, cos, sin, dropout_seed: Optional[int] = None, **attn_kw):
        if self.post_norms:
            x = x + self.post_attention_layernorm(
                self.self_attn(x, cos, sin, dropout_seed=dropout_seed, **attn_kw))
            return x + self.post_feedforward_layernorm(self.mlp(x, dropout_seed))
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, dropout_seed=dropout_seed,
                               **attn_kw)
        return x + self.mlp(self.post_attention_layernorm(x), dropout_seed)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_padded, cfg.hidden_size, dtype=cfg.param_dtype)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, cfg.dtype)
        for i, layer in enumerate(self.layers):
            for name, m in layer.named_modules():
                if isinstance(m, LoRADense):
                    m.dropout_key = f"layers.{i}.{name}"

    def embed(self, input_ids):
        """Token embeddings in ``cfg.dtype``. A row shard of the table
        (``parallel.sharding.split_embedding``) looks up the ids it owns,
        gives zero rows for the others and adds the shards' rows over its
        group, so its gradient reaches only its own rows."""
        table = self.embed_tokens
        tp = getattr(table, "tp", None)
        if tp is None or tp.group is None:
            return table(input_ids).to(self.cfg.dtype)
        rows = self.cfg.vocab_padded // tp.size
        local = input_ids - tp.rank * rows
        own = (local >= 0) & (local < rows)
        x = torch.where(own[..., None], table(torch.where(own, local, 0)), 0.0)
        return reduce_from_group(x, tp.group).to(self.cfg.dtype)

    def forward(self, input_ids=None, *, inputs_embeds=None, cache: Optional[KVCache] = None,
                attention_mask: Optional[torch.Tensor] = None,
                seq_lengths: Optional[Sequence[int]] = None,
                dropout_seed: Optional[int] = None):
        """Returns the final-norm hidden states (B, S, D). With a cache, the
        call appends a (B, S) block to every row and advances
        ``cache.length``: by S, or with ``seq_lengths`` (B,) host ints by
        each row's true length of a right-padded block. Without one,
        ``attention_mask`` (B, S) marks suffix padding, and with
        ``cfg.remat`` each layer is recomputed in the backward.
        ``dropout_seed`` turns on LoRA dropout in training mode."""
        cfg = self.cfg
        x = (self.embed(input_ids) if inputs_embeds is None else inputs_embeds).to(cfg.dtype)
        start, kv_len, cos, sin, new_len = step_plan(cfg, x, cache, attention_mask, seq_lengths)
        use_remat = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            kw = dict(layer_idx=i, cache=cache, start=start, kv_len=kv_len,
                      dropout_seed=dropout_seed)
            if use_remat:  # the recompute draws the same dropout masks (derive_seed),
                # so the global RNG state need not be saved and restored
                x = checkpoint(layer, x, cos, sin, use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = layer(x, cos, sin, **kw)
        if cache is not None:
            cache.length = [st + n for st, n in zip(cache.length, new_len)]
        return self.norm(x)


def step_plan(cfg: LlamaConfig, x: torch.Tensor, cache: Optional[KVCache],
              attention_mask: Optional[torch.Tensor], seq_lengths: Optional[Sequence[int]]):
    """What every layer of one forward over x (B, S, D) shares: each row's
    start (B,) and key count (B,) (None without a cache or mask), the RoPE
    tables, and each row's new length (host ints; None without a cache).
    See :meth:`LlamaModel.forward`."""
    b, s, _ = x.shape
    new_len = None
    if cache is not None:
        if max(cache.length) + s > cache.capacity:
            raise ValueError(f"KV cache overflow: {max(cache.length)} + {s} tokens "
                             f"> capacity {cache.capacity}")
        start_host = cache.length
        new_len = [s] * b if seq_lengths is None else [int(n) for n in seq_lengths]
        if len(new_len) != b or not all(0 <= n <= s for n in new_len):
            raise ValueError(f"seq_lengths {new_len} must be {b} values in 0..{s}")
    else:
        start_host = [0] * b
    start = torch.tensor(start_host, dtype=torch.int32, device=x.device)
    kv_len = None
    if cache is not None:
        kv_len = (start + s if seq_lengths is None else
                  torch.tensor([st + n for st, n in zip(start_host, new_len)],
                               dtype=torch.int32, device=x.device))
    elif attention_mask is not None:
        kv_len = attention_mask.to(torch.int32).sum(dim=-1)
    positions = start[:, None] + torch.arange(s, device=x.device)[None, :]
    cos, sin = rope_frequencies(
        cfg.head_dim, positions, base=cfg.rope_theta, scaling_type=cfg.rope_scaling_type,
        scaling_factor=cfg.rope_scaling_factor,
        max_position_embeddings=cfg.max_position_embeddings,
        seq_len=float(max(start_host) + s))
    return start, kv_len, cos, sin, new_len


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg)
        self.lm_head = LoRADense(cfg.hidden_size, cfg.vocab_padded, dtype=cfg.dtype,
                                 param_dtype=cfg.param_dtype)

    def forward(self, input_ids=None, *, inputs_embeds=None, cache: Optional[KVCache] = None,
                attention_mask: Optional[torch.Tensor] = None,
                seq_lengths: Optional[Sequence[int]] = None,
                logits_indices: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None):
        """``logits_indices`` (B,): lm_head only at those positions -> (B, 1, V).
        ``seq_lengths``: see :meth:`LlamaModel.forward`.
        Returns {"logits", "hidden_states", "cache"}."""
        hidden = self.model(input_ids, inputs_embeds=inputs_embeds, cache=cache,
                            attention_mask=attention_mask, seq_lengths=seq_lengths,
                            dropout_seed=dropout_seed)
        head_in = hidden
        if logits_indices is not None:
            rows = torch.arange(hidden.shape[0], device=hidden.device)
            head_in = hidden[rows, logits_indices.to(hidden.device)][:, None]
        return {"logits": self._logits(head_in), "hidden_states": hidden, "cache": cache}

    def vocab_shard(self) -> Optional[Tuple[int, object]]:
        """(first vocabulary id, process group) of this rank's columns of the
        logits when ``lm_head`` is a column shard over a group
        (``parallel.sharding.split_vocab_``), else None."""
        tp = getattr(self.lm_head, "tp", None)
        if tp is None or tp.group is None:
            return None
        return tp.rank * (self.cfg.vocab_padded // tp.size), tp.group

    def _logits(self, hidden):
        """The logits, rows past ``vocab_size`` masked to -1e9; on a
        vocabulary shard, this shard's columns (its padding mask at its own
        offset)."""
        logits = self.lm_head(hidden)
        cfg = self.cfg
        if cfg.vocab_padded != cfg.vocab_size:
            shard = self.vocab_shard()
            first = 0 if shard is None else shard[0]
            ids = torch.arange(first, first + logits.shape[-1], device=logits.device)
            logits = logits.masked_fill(ids >= cfg.vocab_size, -1e9)
        return logits

    def embed(self, input_ids):
        return self.model.embed(input_ids)

    def hidden_states(self, input_ids=None, *, inputs_embeds=None, attention_mask=None,
                      dropout_seed: Optional[int] = None):
        """Decoder stack only, no lm_head; pair with :meth:`chunked_loss`."""
        return self.model(input_ids, inputs_embeds=inputs_embeds,
                          attention_mask=attention_mask, dropout_seed=dropout_seed)

    def chunked_loss(self, hidden, labels, ignore_index: int = -100):
        """Next-token CE, equal to ``cross_entropy_loss(logits, labels)``,
        taken in ``cfg.ce_chunk_size`` sequence chunks. Each chunk's logits
        and log-softmax live only inside a checkpointed call and are
        recomputed in the backward, so (B, S, V) logits never exist. The
        last chunk is shorter instead of padded. On a vocabulary shard the
        CE is taken over the shards (:func:`vocab_parallel_log_likelihood`)."""
        chunk = self.cfg.ce_chunk_size or hidden.shape[1]
        h, lab = hidden[:, :-1], labels[:, 1:]
        totals = torch.zeros(2, dtype=torch.float32, device=hidden.device)
        for s0 in range(0, h.shape[1], chunk):
            totals = totals + checkpoint(self._ce_sums, h[:, s0:s0 + chunk],
                                         lab[:, s0:s0 + chunk], ignore_index,
                                         use_reentrant=False, preserve_rng_state=False)
        return global_mean(totals[0], totals[1], floor=1.0)

    def _ce_sums(self, hidden, labels, ignore_index: int):
        return _nll_sums(self._logits(hidden), labels, ignore_index, self.vocab_shard())


class _VocabParallelLogLikelihood(torch.autograd.Function):
    """log softmax(logits)[target] from the vocabulary shards of the logits
    over a process group, each rank holding columns ``[first, first + n)``
    in f32: the row max all-reduced with MAX, the sum of exponentials with
    SUM, the target's logit from the shard that owns it by SUM. The
    gradient to a shard's logits is its slice of (one-hot - softmax)."""

    @staticmethod
    def forward(ctx, logits, target, first, group):
        n = logits.shape[-1]
        peak = logits.amax(dim=-1)
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
        exp = torch.exp(logits - peak[..., None])
        total = exp.sum(dim=-1)
        dist.all_reduce(total, group=group)
        local = target - first
        own = (local >= 0) & (local < n)
        index = torch.where(own, local, 0)
        hit = torch.where(own, logits.gather(-1, index[..., None])[..., 0], 0.0)
        dist.all_reduce(hit, group=group)
        ctx.save_for_backward(exp, total, index, own)
        return hit - (peak + torch.log(total))

    @staticmethod
    def backward(ctx, g):
        exp, total, index, own = ctx.saved_tensors
        grad = exp / total[..., None] * -g[..., None]
        grad.scatter_add_(-1, index[..., None], torch.where(own, g, 0.0)[..., None])
        return grad, None, None, None


def vocab_parallel_log_likelihood(logits, target, first: int, group):
    """(...) log-likelihood in f32 of ``target`` (global vocabulary ids)
    under the softmax over every shard's logits, from this rank's shard
    ``logits`` (..., n) of columns ``[first, first + n)``; its gradient
    reaches this shard's logits only. A collective over ``group``."""
    return _VocabParallelLogLikelihood.apply(logits.float(), target, first, group)


def _nll_sums(logits, labels, ignore_index: int, vocab: Optional[Tuple[int, object]] = None):
    """(summed negative log-likelihood in f32, number of supervised tokens)
    of ``logits`` against ``labels`` at the same positions; ``vocab`` =
    (first id, group): ``logits`` is this rank's vocabulary shard
    (``LlamaForCausalLM.vocab_shard``)."""
    valid = labels != ignore_index
    target = torch.where(valid, labels, 0).long()
    if vocab is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        tll = logp.gather(-1, target[..., None])[..., 0]
    else:
        tll = vocab_parallel_log_likelihood(logits, target, *vocab)
    return torch.stack([-(tll * valid).sum(), valid.sum().float()])


def cross_entropy_loss(logits, labels, ignore_index: int = -100,
                       vocab: Optional[Tuple[int, object]] = None):
    """Mean next-token CE over supervised positions (logits[:, :-1] against
    labels[:, 1:]), in f32; ``vocab``: see :func:`_nll_sums`."""
    nll, count = _nll_sums(logits[:, :-1], labels[:, 1:], ignore_index, vocab)
    return global_mean(nll, count, floor=1.0)


def lora_trainable_mask(module: nn.Module) -> Dict[str, bool]:
    """Parameter name -> trained in the reference LoRA recipe: ``lora_A`` /
    ``lora_B``, both decoder layernorms, any module named ``norm`` (the final
    norm), ``embed_tokens`` and ``lm_head``; the counterpart of the JAX
    ``lora_trainable_mask``."""
    trained = {"lora_A", "lora_B", "input_layernorm", "post_attention_layernorm", "norm",
               "embed_tokens", "lm_head"}
    return {name: bool(trained.intersection(name.split(".")))
            for name, _ in module.named_parameters()}


QUANT_MODULES = frozenset(("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                           "down_proj"))


def quantize_llama_(module: nn.Module) -> nn.Module:
    """In place, the counterpart of the JAX ``quantize_llama_params``: every
    ``LoRADense`` named like one of the seven projections (``QUANT_MODULES``)
    gets an int8 weight with per-output-channel scales, and so does every
    expert's stacked weight of a mixture of experts (``models/moe.py``:
    per expert and output channel). LoRA, norms, embeddings, ``lm_head``,
    the routers and the resamplers (none of whose modules bears such a name)
    stay as they are. One projection (one expert) is converted at a time, so
    the transient peak is one projection's f32 copy."""
    from .moe import RoutedExperts

    for name, m in module.named_modules():
        if isinstance(m, LoRADense) and name.rpartition(".")[2] in QUANT_MODULES:
            m.quantize_()
        elif isinstance(m, RoutedExperts):
            m.quantize_()
    return module
