"""The mixture of experts of a decoder layer (K-EXAONE's, after
DeepSeek-V3's ``noaux_tc`` router with one group), for
``models/llama.py``'s ``LlamaDecoderLayer`` in the layers that
``LlamaConfig.moe`` gives experts. The JAX package has no counterpart.

For h (T, D):

    s = sigmoid(h W_r^T)                      f32, one score an expert
    chosen = top_k(s + b)                     b: e_score_correction_bias, for the choice only
    w = routed_scaling_factor * s[chosen] / sum s[chosen]
    out = sum_{e in chosen, e held} w_e E_e(h) + S(h)

E_e and the shared expert S are SwiGLUs ``MoEConfig.intermediate_size``
wide (S as wide times ``num_shared_experts``). Parameter names follow HF's
DeepSeek-V3 / EXAONE-MoE: ``gate.weight``, ``gate.e_score_correction_bias``,
``experts.gate_up_proj`` (E, 2I, D: gate rows then up rows),
``experts.down_proj`` (E, D, I), ``shared_experts.{gate,up,down}_proj``
(``LoRADense``, with LoRA where the configuration has it; the routed experts
take none).

**The layer is told which experts it holds** (``MoEConfig.held``): it
routes over all ``num_experts`` and computes only its own experts' part of
the result, as a device of expert parallelism does; run alone it runs
without the exchange, and what the absent experts would add is left out.
The shared expert is computed whole on every device.

**Dispatch on the device.** The (token, slot) pairs are sorted by held
expert on the device (``torch.sort``, the pairs of experts not held last)
and ``searchsorted`` gives each held expert's run; no count comes to the
host. A pair's output lands in row ``token * top_k + slot`` of a zeroed
(T * top_k, D) buffer, and the weighted sum over a token's slots is taken in
f32 in slot order, so a token's result does not depend on the other tokens
of the call.

**The products.** int8 experts (``quantize_base`` / ``quantize_llama_``:
per expert and output channel) take ``ops.int8_linear.grouped_int8_linear``
in a short query block (at most ``llama.SHORT_BLOCK`` positions a row, the
decode and verify passes, as attention's decode path): gate and up in one
launch, down in another, with no host sync and no shape that depends on the
routing. A longer block (a prefill) reads the counts once and runs kernel A
or C (``int8_linear``) once per held expert with pairs. On CPU tensors the
grouped product's plain version, a loop over the experts, runs. Float
experts loop over the experts with ``F.linear``.

Under a profiler the router, top-k and dispatch are the span ``moe.route``
and the expert products and the combine ``moe.experts``
(``utils/tracing.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_linear import grouped_int8_linear, int8_linear
from ..utils import tracing
from .llama import SHORT_BLOCK, LlamaConfig, LlamaMLP, quantize_weight


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """``held``: (first expert, count) of the experts this device holds
    (None: every expert)."""
    num_experts: int = 128
    experts_per_token: int = 8
    intermediate_size: int = 2048
    num_shared_experts: int = 1
    routed_scaling_factor: float = 2.5
    held: Optional[Tuple[int, int]] = None

    @property
    def held_range(self) -> Tuple[int, int]:
        return self.held or (0, self.num_experts)


class Router(nn.Module):
    """The sigmoid router: f32 scores, top-k on the bias-corrected scores,
    the chosen scores normalized and scaled."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        m = cfg.moe
        self.top_k, self.scaling = m.experts_per_token, m.routed_scaling_factor
        self.weight = nn.Parameter(torch.empty(m.num_experts, cfg.hidden_size,
                                               dtype=cfg.param_dtype), requires_grad=False)
        self.e_score_correction_bias = nn.Parameter(torch.zeros(m.num_experts),
                                                    requires_grad=False)

    def forward(self, h: torch.Tensor):
        """h (T, D) -> (weights (T, top_k) f32, experts (T, top_k) int64)."""
        scores = torch.sigmoid(F.linear(h.float(), self.weight.float()))
        experts = torch.topk(scores + self.e_score_correction_bias.float(), self.top_k,
                             dim=-1).indices
        w = scores.gather(1, experts)
        return w / w.sum(dim=-1, keepdim=True) * self.scaling, experts


class RoutedExperts(nn.Module):
    """The held experts' SwiGLUs, stacked: ``gate_up_proj`` (E, 2I, D) and
    ``down_proj`` (E, D, I), float or (after :meth:`quantize_`) int8 with
    per-expert, per-output-channel f32 scales ``gate_up_proj_scale`` (E,
    2I) and ``down_proj_scale`` (E, D)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        m = cfg.moe
        e, i, d = m.held_range[1], m.intermediate_size, cfg.hidden_size
        self.dtype, self.width = cfg.dtype, i
        for name, shape in (("gate_up_proj", (e, 2 * i, d)), ("down_proj", (e, d, i))):
            if cfg.quantize_base:
                setattr(self, name, nn.Parameter(torch.zeros(shape, dtype=torch.int8),
                                                 requires_grad=False))
                setattr(self, name + "_scale", nn.Parameter(torch.ones(shape[:2]),
                                                            requires_grad=False))
            else:
                setattr(self, name, nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype),
                                                 requires_grad=False))

    @property
    def quantized(self) -> bool:
        return self.gate_up_proj.dtype == torch.int8

    @torch.no_grad()
    def quantize_(self) -> "RoutedExperts":
        """In place: each expert's weights become int8 with per-output-channel
        scales (``quantize_weight``), one expert at a time."""
        if self.quantized:
            return self
        for name in ("gate_up_proj", "down_proj"):
            w = getattr(self, name)
            q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
            scale = torch.empty(w.shape[:2], dtype=torch.float32, device=w.device)
            for e in range(w.shape[0]):
                q[e], scale[e] = quantize_weight(w[e])
            setattr(self, name, nn.Parameter(q, requires_grad=False))
            setattr(self, name + "_scale", nn.Parameter(scale, requires_grad=False))
        return self

    def _product(self, x, name: str, e: int):
        w = getattr(self, name)
        if self.quantized:
            return int8_linear(x, w[e], getattr(self, name + "_scale")[e])
        return F.linear(x, w[e].to(self.dtype))

    def _act(self, gate_up):
        return F.silu(gate_up[:, :self.width]) * gate_up[:, self.width:]

    def forward(self, h: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
                top_k: int, grouped: bool) -> torch.Tensor:
        """h (T, D); ``order`` / ``offsets`` the dispatch (:meth:`MoE.dispatch`).
        Returns (T * top_k, D): row t * top_k + j the output of token t's
        j-th chosen expert if held here, else zero. ``grouped``: the grouped
        product (no host sync); else a loop over the held experts."""
        if self.quantized and grouped:
            gate_up = grouped_int8_linear(h, self.gate_up_proj, self.gate_up_proj_scale,
                                          order, offsets, top_k)
            return grouped_int8_linear(self._act(gate_up), self.down_proj,
                                       self.down_proj_scale, order, offsets, 1)
        out = h.new_zeros((h.shape[0] * top_k, h.shape[1]))
        bounds = offsets.tolist()
        for e in range(self.gate_up_proj.shape[0]):
            pairs = order[bounds[e]:bounds[e + 1]].long()
            if len(pairs):
                act = self._act(self._product(h[pairs // top_k], "gate_up_proj", e))
                out[pairs] = self._product(act, "down_proj", e)
        return out


class MoE(nn.Module):
    """The FFN of an expert layer (see the module's notes)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        m = cfg.moe
        self.cfg = cfg
        self.gate = Router(cfg)
        self.experts = RoutedExperts(cfg)
        self.shared_experts = LlamaMLP(cfg, width=m.intermediate_size * m.num_shared_experts)
        self.register_buffer("bounds", torch.arange(m.held_range[1] + 1), persistent=False)

    def dispatch(self, experts: torch.Tensor):
        """(T, top_k) chosen experts -> (order (T * top_k,) int32: the pairs
        sorted by held expert, the others last; offsets (held + 1,) int32:
        held expert e's pairs are order[offsets[e]:offsets[e + 1]])."""
        first, n = self.cfg.moe.held_range
        local = experts.reshape(-1) - first
        key = torch.where((local >= 0) & (local < n), local, n)
        key, order = torch.sort(key, stable=True)
        offsets = torch.searchsorted(key, self.bounds)
        return order.to(torch.int32), offsets.to(torch.int32)

    def forward(self, x: torch.Tensor, dropout_seed: Optional[int] = None) -> torch.Tensor:
        b, s, d = x.shape
        h = x.reshape(b * s, d)
        k = self.cfg.moe.experts_per_token
        with tracing.span("moe.route"):
            w, experts = self.gate(h)
            order, offsets = self.dispatch(experts)
        with tracing.span("moe.experts"):
            y = self.experts(h, order, offsets, k, grouped=not h.is_cuda or s <= SHORT_BLOCK)
            routed = (y.view(b * s, k, d).float() * w[..., None]).sum(dim=1)
        out = routed + self.shared_experts(h, dropout_seed).float()
        return out.to(x.dtype).view(b, s, d)
