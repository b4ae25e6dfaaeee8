"""A plain float32 reference of the K-EXAONE decoder (``exaone_moe``: EXAONE
4.0's block with DeepSeek-V3's router), written from the layer equations with
no cache and no batching, for the CPU tests of the port
(``tests/test_torch_kexaone.py``). It imports nothing of the port: it reads a
state dict under the port's (HF's) parameter names and a dict of sizes.

For layer l with window W_l (0: a global layer):

- attention: q = x W_q, k = x W_k, v = x W_v; q, k <- RMSNorm over each
  head's channels (q_norm, k_norm); RoPE (half rotation, ``rope_theta``) in
  windowed layers only, none in global ones; key j is visible to query i iff
  j <= i and, in a windowed layer, i - j < W_l; scale 1 / sqrt(head_dim); GQA
  repeats each KV head over its group; out = o W_o;
- block: h = x + RMSNorm_pa(attn(x)); y = h + RMSNorm_pf(ffn(h)), no norm
  before a sublayer; a final RMSNorm and an untied lm_head after the stack;
- ffn: layers below ``first_k_dense_replace`` a SwiGLU; the others the
  mixture of experts: s = sigmoid(h W_r^T); chosen = top_k(s + b) (b the
  e_score_correction_bias, for the choice only); w = scale * s[chosen] /
  sum s[chosen]; out = sum over chosen e of w_e E_e(h) + S(h), E_e and the
  shared expert S SwiGLUs.

Departures, each also the port's: the experts are those a device holds
(``held`` = (first, count) of the layer's experts; the others add nothing,
as on a device of expert parallelism without the exchange), and LoRA adds
(alpha / r) B A x to a projection that has it. LoRA dropout is training's
only and is not here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def proj(sd: Dict[str, torch.Tensor], name: str, x: torch.Tensor, scaling: float):
    """x W^T, plus the LoRA term where the state dict has one."""
    y = x @ sd[name + ".weight"].T
    if name + ".lora_A.weight" in sd:
        y = y + scaling * (x @ sd[name + ".lora_A.weight"].T) @ sd[name + ".lora_B.weight"].T
    return y


def rope(t: torch.Tensor, theta: float) -> torch.Tensor:
    """(H, S, d) rotated at positions 0 .. S - 1."""
    s, d = t.shape[1], t.shape[2]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    ang = torch.arange(s, dtype=torch.float64)[:, None] * inv[None]
    cos, sin = (torch.cat([ang, ang], -1).cos().float(), torch.cat([ang, ang], -1).sin().float())
    rot = torch.cat([-t[..., d // 2:], t[..., :d // 2]], dim=-1)
    return t * cos + rot * sin


def attention(q, k, v, window: int) -> torch.Tensor:
    """(H, S, d) q against (Hkv, S, d) k, v under the visibility rule above."""
    h, s, d = q.shape
    group = h // k.shape[0]
    k, v = k.repeat_interleave(group, 0), v.repeat_interleave(group, 0)
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    visible = j <= i
    if window:
        visible = visible & (i - j < window)
    scores = (q @ k.transpose(1, 2)) / math.sqrt(d)
    scores = scores.masked_fill(~visible, float("-inf"))
    return torch.softmax(scores, dim=-1) @ v


def route(sd, pre: str, h: torch.Tensor, c: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (S, top_k), experts (S, top_k)) of the router at ``pre``."""
    s = torch.sigmoid(h @ sd[pre + "gate.weight"].T)
    chosen = torch.topk(s + sd[pre + "gate.e_score_correction_bias"], c["top_k"], dim=-1).indices
    w = s.gather(1, chosen)
    return c["routed_scaling_factor"] * w / w.sum(-1, keepdim=True), chosen


def moe(sd, pre: str, h: torch.Tensor, c: dict, scaling: float, held: Tuple[int, int]):
    """The routed experts' part from the experts in ``held`` (first, count;
    the state dict holds exactly those, in order) plus the shared expert."""
    w, chosen = route(sd, pre, h, c)
    out = torch.zeros_like(h)
    gate_up, down = sd[pre + "experts.gate_up_proj"], sd[pre + "experts.down_proj"]
    width = down.shape[2]
    first, count = held
    for e in range(count):
        tok, slot = (chosen == first + e).nonzero(as_tuple=True)
        if len(tok):
            gu = h[tok] @ gate_up[e].T
            y = (F.silu(gu[:, :width]) * gu[:, width:]) @ down[e].T
            out.index_add_(0, tok, w[tok, slot, None] * y)
    return out + swiglu(sd, pre + "shared_experts.", h, scaling)


def swiglu(sd, pre: str, h: torch.Tensor, scaling: float) -> torch.Tensor:
    return proj(sd, pre + "down_proj",
                F.silu(proj(sd, pre + "gate_proj", h, scaling)) * proj(sd, pre + "up_proj", h,
                                                                       scaling), scaling)


def forward(sd: Dict[str, torch.Tensor], c: dict, x: torch.Tensor,
            held: Tuple[int, int]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x (S, D) input embeddings -> (logits (S, V), the routers' chosen
    experts per expert layer). ``c``: hidden_size, num_attention_heads,
    num_key_value_heads, head_dim, num_hidden_layers, sliding_windows,
    rope_theta, rms_norm_eps, first_k_dense_replace, top_k,
    routed_scaling_factor, lora_scaling, vocab_size."""
    sd = {k: v.float() for k, v in sd.items()}
    h, hkv, hd, eps = (c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"],
                       c["rms_norm_eps"])
    scaling = c["lora_scaling"]
    s = x.shape[0]
    routes = []
    for layer in range(c["num_hidden_layers"]):
        pre = f"model.layers.{layer}."
        a = pre + "self_attn."
        window = c["sliding_windows"][layer]
        q = proj(sd, a + "q_proj", x, scaling).view(s, h, hd).transpose(0, 1)
        k = proj(sd, a + "k_proj", x, scaling).view(s, hkv, hd).transpose(0, 1)
        v = proj(sd, a + "v_proj", x, scaling).view(s, hkv, hd).transpose(0, 1)
        q, k = rms_norm(q, sd[a + "q_norm.weight"], eps), rms_norm(k, sd[a + "k_norm.weight"], eps)
        if window:
            q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
        o = attention(q, k, v, window).transpose(0, 1).reshape(s, h * hd)
        x = x + rms_norm(proj(sd, a + "o_proj", o, scaling),
                         sd[pre + "post_attention_layernorm.weight"], eps)
        m = pre + "mlp."
        if layer < c["first_k_dense_replace"]:
            f = swiglu(sd, m, x, scaling)
        else:
            routes.append(route(sd, m, x, c)[1])
            f = moe(sd, m, x, c, scaling, held)
        x = x + rms_norm(f, sd[pre + "post_feedforward_layernorm.weight"], eps)
    x = rms_norm(x, sd["model.norm.weight"], eps)
    logits = x @ sd["lm_head.weight"].T
    logits[:, c["vocab_size"]:] = -1e9
    return logits, routes
