"""The plain float32 reference of K-EXAONE-236B-A23B as the story agent's LLM
(``exaone_moe``: EXAONE 4.0's block with DeepSeek-V3's ``noaux_tc`` router of
one group), written from the layer equations. For layer l with window W_l
(0: a global layer):

- attention: q = x W_q (64 heads), k = x W_k, v = x W_v (8 KV heads), head
  size 128; q, k <- RMSNorm over each head's 128 channels (q_norm, k_norm);
  RoPE (theta 1e6) in windowed layers only, none in global ones (NoPE); key j
  is visible to query i iff j <= i and, in a windowed layer, i - j < W_l (the
  window counts the query's own key); scale 1 / sqrt(128); out = o W_o;
- block: h = x + RMSNorm_pa(attn(x)); y = h + RMSNorm_pf(ffn(h)), with no
  norm before a sublayer; a final RMSNorm and an untied lm_head follow;
- ffn: layer 0 a dense SwiGLU; the others the mixture of experts: s =
  sigmoid(h W_r^T), 128 scores; chosen = top8(s + b), b the
  e_score_correction_bias, used for the choice only; w = 2.5 s[chosen] /
  sum s[chosen]; out = sum_{e in chosen} w_e E_e(h) + S(h), E_e and the
  shared expert S SwiGLUs 2048 wide.

Departures, each also the program's: a card holds the experts of its share
of an expert-parallel deployment (``held``: experts 0-15 of each layer), so
only they add their part and the others add nothing, as on a card of expert
parallelism without the exchange; LoRA adds (alpha / r) B A x to q, k, v, o
and to the dense and shared experts' projections. The norm placement, the
QK-norm and the NoPE global layers follow EXAONE 4.0 (``exaone4``), which
``exaone_moe`` extends; the router follows DeepSeek-V3's ``noaux_tc``.

No cache and no batching: a layer runs one teacher-forced sequence (1, S,
D) at a time, in float32 with TF32 off (``common.f32_math``). The model is
built one layer at a time (:class:`Layer`), since the whole float32 model
(about 63 GB) would not fit beside the activations; a layer also reports
each position's chosen experts.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .agent import Proj
from .common import Lin, Norm, QwenResampler

def rope(t: torch.Tensor, theta: float) -> torch.Tensor:
    """(1, H, S, d) rotated (half rotation) at positions 0 .. S - 1."""
    s, d = t.shape[2], t.shape[3]
    pos = torch.arange(s, device=t.device, dtype=torch.float32)
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=t.device, dtype=torch.float32) / d)
    ang = pos[:, None] * inv[None]
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
    rot = torch.cat([-t[..., d // 2:], t[..., :d // 2]], dim=-1)
    return t * cos + rot * sin


def attention(q, k, v, window: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (1, H, S, d) q and (1, Hkv, S, d) k, v
    under the visibility rule, one KV head's group of query heads at a
    time."""
    _, h, s, d = q.shape
    group = h // k.shape[1]
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    hidden = j > i
    if window:
        hidden = hidden | (i - j >= window)
    out = torch.empty_like(q)
    for kv in range(k.shape[1]):
        heads = slice(kv * group, (kv + 1) * group)
        sc = (q[:, heads] @ k[:, kv:kv + 1].transpose(-1, -2)) / math.sqrt(d)
        out[:, heads] = torch.softmax(sc.masked_fill(hidden, float("-inf")), -1) @ v[:, kv:kv + 1]
    return out


def swiglu(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return m.down_proj(F.silu(m.gate_proj(x)) * m.up_proj(x))


class Router(nn.Module):
    def __init__(self, experts: int, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, d), requires_grad=False)
        self.e_score_correction_bias = nn.Parameter(torch.empty(experts), requires_grad=False)


class Experts(nn.Module):
    def __init__(self, held: int, d: int, width: int):
        super().__init__()
        self.gate_up_proj = nn.Parameter(torch.empty(held, 2 * width, d), requires_grad=False)
        self.down_proj = nn.Parameter(torch.empty(held, d, width), requires_grad=False)


def _mlp(d: int, width: int, r: int, alpha: float) -> nn.Module:
    m = nn.Module()
    m.gate_proj, m.up_proj = Proj(d, width, r, alpha), Proj(d, width, r, alpha)
    m.down_proj = Proj(width, d, r, alpha)
    return m


class Layer(nn.Module):
    """Decoder layer ``index`` under the program's names (``self_attn``,
    ``post_attention_layernorm``, ``post_feedforward_layernorm``, ``mlp``)."""

    def __init__(self, c: dict, index: int):
        super().__init__()
        d, r, a = c["hidden_size"], c["lora_rank"], c["lora_alpha"]
        h, hkv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        self.c, self.window = c, c["sliding_windows"][index]
        self.dense = index < c["first_k_dense_replace"]
        self.self_attn = nn.Module()
        for name, n_in, n_out in (("q_proj", d, h * hd), ("k_proj", d, hkv * hd),
                                  ("v_proj", d, hkv * hd), ("o_proj", h * hd, d)):
            setattr(self.self_attn, name, Proj(n_in, n_out, r, a))
        self.self_attn.q_norm = Norm(hd, c["rms_norm_eps"], bias=False)
        self.self_attn.k_norm = Norm(hd, c["rms_norm_eps"], bias=False)
        self.post_attention_layernorm = Norm(d, c["rms_norm_eps"], bias=False)
        self.post_feedforward_layernorm = Norm(d, c["rms_norm_eps"], bias=False)
        if self.dense:
            self.mlp = _mlp(d, c["intermediate_size"], r, a)
        else:
            self.mlp = nn.Module()
            self.mlp.gate = Router(c["router_experts"], d)
            self.mlp.experts = Experts(c["held_experts"], d, c["moe_intermediate_size"])
            self.mlp.shared_experts = _mlp(d, c["moe_intermediate_size"] * c["num_shared_experts"],
                                           r, a)

    def forward(self, x: torch.Tensor):
        """x (1, S, D) -> (y, the chosen experts (S, 8) or None)."""
        c, at = self.c, self.self_attn
        s, h, hkv, hd = x.shape[1], c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        q = at.q_norm(at.q_proj(x).view(1, s, h, hd)).transpose(1, 2)
        k = at.k_norm(at.k_proj(x).view(1, s, hkv, hd)).transpose(1, 2)
        v = at.v_proj(x).view(1, s, hkv, hd).transpose(1, 2)
        if self.window:
            q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
        o = attention(q, k, v, self.window).transpose(1, 2).reshape(1, s, h * hd)
        x = x + self.post_attention_layernorm(at.o_proj(o))
        if self.dense:
            return x + self.post_feedforward_layernorm(swiglu(self.mlp, x)), None
        f, chosen = self.moe(x[0])
        return x + self.post_feedforward_layernorm(f[None]), chosen

    def moe(self, h: torch.Tensor):
        """The routed experts held here plus the shared expert, for h (S, D),
        and the chosen experts."""
        c, m = self.c, self.mlp
        s = torch.sigmoid(h @ m.gate.weight.T)
        chosen = torch.topk(s + m.gate.e_score_correction_bias, c["num_experts_per_tok"],
                            dim=-1).indices
        w = s.gather(1, chosen)
        w = c["routed_scaling_factor"] * w / w.sum(-1, keepdim=True)
        out = swiglu(m.shared_experts, h)
        width = c["moe_intermediate_size"]
        for e in range(m.experts.gate_up_proj.shape[0]):
            tok, slot = (chosen == c["first_held_expert"] + e).nonzero(as_tuple=True)
            if len(tok):
                gu = h[tok] @ m.experts.gate_up_proj[e].T
                y = (F.silu(gu[:, :width]) * gu[:, width:]) @ m.experts.down_proj[e].T
                out.index_add_(0, tok, w[tok, slot, None] * y)
        return out, chosen


class LLM(nn.Module):
    """The LLM's non-layer parameters under the program's names; the layers
    are built one at a time (:class:`Layer`)."""

    def __init__(self, c: dict, layers: nn.Module):
        super().__init__()
        self.c = c
        self.model = nn.Module()
        self.model.embed_tokens = nn.Module()
        self.model.embed_tokens.weight = nn.Parameter(
            torch.empty(c["padded_vocab_size"], c["hidden_size"]), requires_grad=False)
        self.model.layers = layers
        self.model.norm = Norm(c["hidden_size"], c["rms_norm_eps"], bias=False)
        self.lm_head = Lin(c["hidden_size"], c["padded_vocab_size"], bias=False)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        out = self.lm_head(hidden)
        out[..., self.c["vocab_size"]:] = -1e9
        return out


class Agent(nn.Module):
    """The agent's LLM and resamplers under the program's names.
    ``layers``: a ModuleList of every :class:`Layer` (for the names and
    shapes, built on the meta device), or an empty one."""

    def __init__(self, c: dict, layers: nn.Module):
        super().__init__()
        a, d = c["agent"], c["hidden_size"]
        self.llm = LLM(c, layers)
        self.input_resampler = QwenResampler(a["input_resampler_grid"], d, a["resampler_heads"],
                                             a["vit_dim"])
        self.output_resampler = QwenResampler(a["output_resampler_grid"], a["vit_dim"],
                                              a["resampler_heads"], d)
