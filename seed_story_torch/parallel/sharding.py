"""The sharding presets, on the port's parameter names; counterpart of
``seed_story_tpu/parallel/sharding.py``.

The JAX package maps flax logical axes onto the ``(data, model)`` mesh with
one rule table per preset. The port lays the same presets out with FSDP2
and a Megatron split of the LLaMA projections:

  * ``dp``: parameters replicated, the batch split over ``data``; the
    gradient is averaged over ``data`` after the backward (DDP semantics:
    the mean over the global batch);
  * ``fsdp``: ZeRO-3: ``torch.distributed.fsdp.fully_shard`` on every
    decoder layer, every direct child of the LLaMA and of the trained model
    (the towers), and the root, over ``data``; parameters, gradients and the
    AdamW moments live as shards of dim 0 (FSDP2 shards dim 0 of every
    parameter, and pads it to a multiple of the axis), except the int8
    weights of a ``quantize_base`` base and trainable parameters of a
    unit's minority dtype (f32 norms beside bf16 LoRA), which stay whole
    (the latter averaged like ``dp``'s);
  * ``fsdp_tp``: ``fsdp`` plus Megatron tensor parallelism over ``model``:
    the column split of q / k / v / gate / up (``heads`` / ``mlp`` rows) and
    the row split of o / down (their ``heads`` / ``mlp`` columns), written
    once in :func:`split_dense` and used by the tensor-parallel decode as
    well (``decode/tensor_parallel.py``). Embeddings, norms and ``lm_head``
    stay whole on ``model``.

The JAX rule tables, logical axis -> mesh axis (batch: per-example
activations; embed: hidden; mlp: FFN intermediate; heads: heads * head_dim;
vocab; layer: the scan_layers depth axis; lora: the LoRA rank; embed_kv /
kv: resampler and latent kv dims; none of these last four is sharded):

    axis     dp     fsdp   fsdp_tp
    batch    data   data   data
    embed    -      -      data
    mlp      -      data   model
    heads    -      data   model
    vocab    -      data   model

A dimension that FSDP pads (dim 0 of a sharded parameter that does not
divide ``data``) is logged loudly, as the JAX package logs one that XLA
replicates; a tensor-parallel dim that does not divide ``model`` raises
(:func:`split_dense`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

logger = logging.getLogger(__name__)

PRESETS = ("dp", "fsdp", "fsdp_tp")
# the Megatron split of each projection: column (output rows) or row (input columns)
TP_STYLES = {"q_proj": "col", "k_proj": "col", "v_proj": "col", "gate_proj": "col",
             "up_proj": "col", "o_proj": "row", "down_proj": "row"}


# -- tensor parallelism ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPSpec:
    """A projection's place in a tensor-parallel group: its ``style``
    ("col" or "row"), this shard's ``rank`` of ``size``, and the process
    group whose collectives join the shards (None in the one-process decode,
    which adds the row shards' partial outputs itself)."""

    style: str
    rank: int
    size: int
    group: object = None


def _slice(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"tensor parallelism: dim {dim} of size {n} does not divide {size}")
    step = n // size
    return t.detach().narrow(dim, rank * step, step).contiguous().clone()


def split_dense(dense: nn.Module, style: str, rank: int, size: int, group=None,
                device=None) -> nn.Module:
    """The Megatron shard ``rank`` of ``size`` of a ``LoRADense``, as a new
    ``LoRADense`` (on ``device``, default the original's):

      * "col": the weight's output rows, with their scales and bias and
        ``lora_B`` rows; ``lora_A`` whole;
      * "row": the weight's input columns and ``lora_A``'s; ``lora_B`` and
        the scales whole. Row-split projections have no bias (the LLaMA's
        have none), so the shards' partial outputs add up to the output.

    The shard keeps the original's dropout key and trainable flags, and
    records its ``TPSpec`` (with ``group``) in ``tp``."""
    from ..models.llama import LoRADense

    if style not in ("col", "row"):
        raise ValueError(f"unknown tensor-parallel style {style!r}")
    if style == "row" and dense.bias is not None:
        raise ValueError("a row-parallel projection with a bias is not supported")
    device = device if device is not None else dense.weight.device
    n_out, n_in = dense.weight.shape
    out_f, in_f = (n_out // size, n_in) if style == "col" else (n_out, n_in // size)
    with torch.device("meta"):
        shard = LoRADense(in_f, out_f, bias=dense.bias is not None, lora_rank=dense.lora_rank,
                          lora_dropout=dense.lora_dropout, quantize=dense.quantized,
                          dtype=dense.dtype)  # every parameter is replaced below
    shard.dropout_key = dense.dropout_key
    shard.tp = TPSpec(style, rank, size, group)
    if dense.lora_rank:
        shard.scaling = dense.scaling
    wdim = 0 if style == "col" else 1
    tensors = {"weight": _slice(dense.weight, wdim, rank, size)}
    if dense.quantized:
        tensors["weight_scale"] = (_slice(dense.weight_scale, 0, rank, size) if style == "col"
                                   else dense.weight_scale.detach().clone())
    if dense.bias is not None:
        tensors["bias"] = _slice(dense.bias, 0, rank, size)
    if dense.lora_rank:
        a, b = dense.lora_A.weight, dense.lora_B.weight
        tensors["lora_A.weight"] = (a.detach().clone() if style == "col"
                                    else _slice(a, 1, rank, size))
        tensors["lora_B.weight"] = (_slice(b, 0, rank, size) if style == "col"
                                    else b.detach().clone())
    originals = dict(dense.named_parameters())
    for name, value in tensors.items():
        owner = shard
        *path, leaf = name.split(".")
        for part in path:
            owner = getattr(owner, part)
        setattr(owner, leaf, nn.Parameter(value.to(device),
                                          requires_grad=originals[name].requires_grad))
    return shard


def tp_split_dim(name: str) -> Optional[int]:
    """The dim along which a ``split_dense`` shard holds a slice of the
    parameter ``name`` (None: the shard holds it whole)."""
    parts = name.split(".")
    for i, part in enumerate(parts):
        if part in TP_STYLES:
            leaf, col = ".".join(parts[i + 1:]), TP_STYLES[part] == "col"
            if leaf == "weight":
                return 0 if col else 1
            if leaf in ("weight_scale", "bias", "lora_B.weight"):
                return 0 if col else None
            if leaf == "lora_A.weight":
                return None if col else 1
    return None


def apply_tensor_parallel_(model: nn.Module, group) -> Dict[str, int]:
    """In place: every LLaMA projection of ``model`` becomes this rank's
    ``split_dense`` shard over ``group``. Returns {parameter name: split
    dim} of the sliced parameters (the checkpoint's gather map)."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    for parent in list(model.modules()):
        for child_name, child in list(parent.named_children()):
            if child_name in TP_STYLES and hasattr(child, "lora_rank"):
                setattr(parent, child_name, split_dense(child, TP_STYLES[child_name], rank,
                                                        size, group))
    return {name: d for name, _ in model.named_parameters()
            if (d := tp_split_dim(name)) is not None}


# -- FSDP ----------------------------------------------------------------------


def _unit_types():
    from ..models.llama import LlamaDecoderLayer, LlamaForCausalLM, LlamaModel

    return LlamaDecoderLayer, (LlamaModel, LlamaForCausalLM)


def apply_fsdp_(model: nn.Module, data_mesh) -> set:
    """``fully_shard`` over the 1-D ``data_mesh`` on each decoder layer,
    each direct child with parameters of the LLaMA modules and of ``model``
    (the towers: ViT, resamplers, embeddings, norm, ``lm_head``), then on
    ``model``; children before their parents. Every method the losses call
    then reaches its parameters through a unit's own forward.

    Two kinds of parameters stay whole on every rank, outside FSDP, and are
    returned: the frozen integer ones (a ``quantize_base`` base's int8
    weights, which FSDP cannot hold as parameters; kernel C reads them in
    place), and the trainable ones of another dtype than the most common
    one of their unit (an f32 RMSNorm or LayerNorm beside bf16 LoRA: FSDP
    wants one dtype among a unit's trainable parameters), whose gradients
    are averaged over ``data`` as under ``dp``."""
    from torch.distributed.fsdp import fully_shard

    layer_t, llama_t = _unit_types()
    units = set()
    for m in model.modules():
        if isinstance(m, layer_t):
            units.add(m)
        if m is model or isinstance(m, llama_t):
            units.update(c for c in m.children() if any(True for _ in c.parameters())
                         and not isinstance(c, (nn.ModuleList, nn.ModuleDict)))
    ignored = _minority_dtype_params(model, units)
    ignored |= {p for p in model.parameters() if not p.is_floating_point()}
    for name in padded_by_fsdp(model, ignored, data_mesh.size()):
        # loud: a padded 7B dim is memory and traffic the user cannot
        # diagnose from behavior alone
        logger.warning("sharding: %s dim 0 does not divide mesh axis data (size %d); FSDP "
                       "pads it", name, data_mesh.size())
    for m in [m for m in reversed(list(model.modules())) if m in units]:
        fully_shard(m, mesh=data_mesh, ignored_params=ignored)
    fully_shard(model, mesh=data_mesh, ignored_params=ignored)
    return ignored


def padded_by_fsdp(model: nn.Module, ignored: set, size: int) -> List[str]:
    """The parameters FSDP shards (those not in ``ignored``) whose dim 0 it
    pads to a multiple of ``size``."""
    return [name for name, p in model.named_parameters()
            if p not in ignored and p.dim() and p.shape[0] % size]


def _minority_dtype_params(model: nn.Module, units: set) -> set:
    """The trainable parameters whose dtype is not the most common one (by
    elements) among the trainable parameters their unit (or the root)
    manages itself."""
    out = set()
    for unit in [*units, model]:
        owned = []

        def walk(m):
            owned.extend(p for p in m.parameters(recurse=False) if p.requires_grad)
            for child in m.children():
                if child not in units:
                    walk(child)

        walk(unit)
        counts: Dict[torch.dtype, int] = {}
        for p in owned:
            counts[p.dtype] = counts.get(p.dtype, 0) + p.numel()
        if len(counts) > 1:
            main = max(counts, key=counts.get)
            out.update(p for p in owned if p.dtype != main)
    return out


# -- local views and full tensors ---------------------------------------------


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def to_local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the storage FSDP reads), else ``t``."""
    return t.to_local() if is_dtensor(t) else t


def full_tensor(local: torch.Tensor, like: torch.Tensor, tp_dim: Optional[int] = None,
                tp_group=None) -> torch.Tensor:
    """The whole parameter of which ``local`` is this rank's piece, laid
    out like ``like`` (a DTensor parameter: its mesh and placements; a
    plain one: ``local`` itself), then joined along ``tp_dim`` over
    ``tp_group``. A collective: every rank calls it in the same order."""
    from torch.distributed.tensor import DTensor

    t = local
    if is_dtensor(like):
        t = DTensor.from_local(local, like.device_mesh, like.placements, shape=like.shape,
                               stride=like.stride()).full_tensor()
    if tp_dim is not None and tp_group is not None and dist.get_world_size(tp_group) > 1:
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(tp_group))]
        dist.all_gather(parts, t.contiguous(), group=tp_group)
        t = torch.cat(parts, dim=tp_dim)
    return t


def local_piece(full: torch.Tensor, like: torch.Tensor, tp_dim: Optional[int] = None,
                tp_group=None) -> torch.Tensor:
    """The inverse of :func:`full_tensor`: this rank's piece of ``full``,
    for the local tensor of ``like``."""
    from torch.distributed.tensor import distribute_tensor

    t = full
    if tp_dim is not None and tp_group is not None and dist.get_world_size(tp_group) > 1:
        t = _slice(t, tp_dim, dist.get_rank(tp_group), dist.get_world_size(tp_group))
    if is_dtensor(like):
        t = distribute_tensor(t.to(like.device), like.device_mesh, like.placements,
                              src_data_rank=None).to_local()
    return t
