"""The sharding presets, on the port's parameter names; counterpart of
``seed_story_tpu/parallel/sharding.py``.

The JAX package maps flax logical axes onto the ``(data, model)`` mesh with
one rule table per preset. The port lays the same presets out with FSDP2
and a Megatron split of the LLaMA projections and of the SDXL UNet:

  * ``dp``: parameters replicated, the batch split over ``data``; the
    gradient is averaged over ``data`` after the backward (DDP semantics:
    the mean over the global batch);
  * ``fsdp``: ZeRO-3: ``torch.distributed.fsdp.fully_shard`` over ``data``
    on every LLaMA decoder layer and every UNet block (``ResnetBlock2D``,
    ``BasicTransformerBlock``, the samplers), every direct child of the
    LLaMA and of the trained model (the towers, the adapter's resampler and
    the rest of the UNet), and the root, children before parents, so a
    forward gathers one block at a time; parameters, gradients and the
    AdamW moments live as shards of dim 0 (FSDP2 shards dim 0 of every
    parameter, and pads it to a multiple of the axis). The int8 weights of
    a ``quantize_base`` base and their scales, which FSDP does not hold
    (torch 2.11 refuses integer parameters), are held the same way outside
    it (:func:`shard_int8_base_`): this rank's padded dim-0 slice, which
    the product gathers itself in the forward and again in the backward
    (``ops/int8_linear.py::int8_linear_gathered``). Trainable parameters
    of a unit's minority dtype (f32 norms beside bf16 LoRA) stay whole,
    their gradients averaged like ``dp``'s;
  * ``fsdp_tp``: ``fsdp`` plus Megatron tensor parallelism over ``model``,
    written once in :func:`split_dense` (a shard records its ``TPSpec`` and
    the layer's forward joins the shards) and used by the tensor-parallel
    decode as well (``decode/tensor_parallel.py``):

      - the LLaMA: the column split of q / k / v / gate / up (``heads`` /
        ``mlp`` rows) and the row split of o / down (their ``heads`` /
        ``mlp`` columns); the vocabulary (:func:`split_vocab_`):
        ``embed_tokens`` by rows and ``lm_head`` as a column shard, so the
        embedding adds the shards' rows and the logits and the
        cross-entropy are taken on vocabulary shards
        (``models/llama.py``); the norms stay whole;
      - the SDXL UNet (:func:`split_unet_`, the JAX ``heads`` / ``mlp``
        axes of ``seed_story_tpu/models/sdxl/unet.py``): each attention's
        ``to_q`` / ``to_k`` / ``to_v`` column and ``to_out.0`` row, so a
        shard attends over its own heads; the feed-forward's ``net.0.proj``
        column (each shard holds the same rows of GEGLU's ``h`` half and of
        its ``gate`` half, so the pairs stay together) and ``net.2`` row;
        each ResNet's ``conv1`` and ``time_emb_proj`` column, ``norm2`` on
        the shard's whole groups of ``conv1``'s channels, ``conv2`` row; the
        time and added embeddings' ``linear_1`` column and ``linear_2`` row.
        A row shard's bias is added once, after the shards' partial
        outputs are summed. ``proj_in`` / ``proj_out``, ``conv_shortcut``,
        ``conv_in`` / ``conv_out``, the other norms and the sampler convs
        stay whole: the JAX rules shard the sampler convs' outputs too, but
        a lone column split there would need a gather before the next
        layer, so keeping them whole computes the same thing.

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
divide ``data``, an int8 base weight's too) is logged loudly, as the JAX
package logs one that XLA replicates. So is a UNet layer whose heads or
width, or a vocabulary whose padded size, do not divide ``model``: it
stays whole on every ``model`` rank, as the JAX package replicates such a
dim. A LLaMA width that does not divide ``model`` raises
(:func:`split_dense`), and so does a UNet split that would cut a GroupNorm
group.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

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
    """A layer's place in a tensor-parallel group: its ``style`` ("col" or
    "row"), this shard's ``rank`` of ``size``, the process group whose
    collectives join the shards (None in the one-process decode, which adds
    the row shards' partial outputs itself), and ``chunks``: the number of
    equal blocks of the split dim that each contribute their ``rank``-th
    slice (2 for GEGLU's ``[h | gate]`` projection, else 1)."""

    style: str
    rank: int
    size: int
    group: object = None
    chunks: int = 1


def _slice(t: torch.Tensor, dim: int, rank: int, size: int, chunks: int = 1) -> torch.Tensor:
    """Slice ``rank`` of ``size`` along ``dim`` of each of ``chunks`` equal
    blocks of ``t``, joined."""
    n = t.shape[dim]
    if n % (size * chunks):
        raise ValueError(f"tensor parallelism: dim {dim} of size {n} does not divide "
                         f"{size * chunks}")
    step = n // (size * chunks)
    parts = [block.narrow(dim, rank * step, step) for block in t.detach().chunk(chunks, dim)]
    return torch.cat(parts, dim).contiguous().clone()


def _new_like(layer: nn.Module, out_f: int, in_f: int) -> nn.Module:
    """An empty ``nn.Linear`` / ``nn.Conv2d`` like ``layer`` with other
    widths, on the meta device (every parameter is replaced)."""
    with torch.device("meta"):
        kw = dict(bias=layer.bias is not None, dtype=layer.weight.dtype)
        if isinstance(layer, nn.Conv2d):
            return nn.Conv2d(in_f, out_f, layer.kernel_size, layer.stride, layer.padding, **kw)
        return nn.Linear(in_f, out_f, **kw)


def split_dense(dense: nn.Module, style: str, rank: int, size: int, group=None,
                device=None, chunks: int = 1) -> nn.Module:
    """The Megatron shard ``rank`` of ``size`` of a layer, as a new layer of
    its kind (on ``device``, default the original's) that records its
    ``TPSpec`` (with ``group``) in ``tp``, and keeps the original's
    trainable flags:

      * a ``LoRADense`` (the LLaMA's projections), "col": the weight's output
        rows, with their scales and bias and ``lora_B`` rows; ``lora_A``
        whole; "row": the weight's input columns and ``lora_A``'s;
        ``lora_B`` and the scales whole. Row-split projections have no bias
        (the LLaMA's have none), so the shards' partial outputs add up to
        the output. The shard keeps the original's dropout key;
      * an ``nn.Linear`` or ``nn.Conv2d`` (the UNet's), "col": its output
        rows (channels) and their bias, from each of ``chunks`` blocks;
        "row": its input columns (channels); the bias whole, added once to
        the summed partial outputs (``ops/dense.py::linear``,
        ``models/sdxl/unet.py::conv_nhwc``);
      * a ``FastGroupNorm`` over a column shard's channels ("col" only): its
        weight and bias for those channels and ``num_groups / size`` of its
        groups; a split that would cut a group raises."""
    from ..models.llama import LoRADense
    from ..ops.groupnorm import FastGroupNorm

    if style not in ("col", "row"):
        raise ValueError(f"unknown tensor-parallel style {style!r}")
    device = device if device is not None else dense.weight.device
    spec = TPSpec(style, rank, size, group, chunks)
    if isinstance(dense, FastGroupNorm):
        if style != "col" or dense.num_groups % size:
            raise ValueError(f"tensor parallelism: a GroupNorm of {dense.num_groups} groups "
                             f"over {dense.weight.shape[0]} channels cannot follow a {style} "
                             f"split of {size}: it would cut a group")
        with torch.device("meta"):
            shard = FastGroupNorm(dense.num_groups // size, dense.weight.shape[0] // size,
                                  dense.eps)
        tensors = {"weight": _slice(dense.weight, 0, rank, size),
                   "bias": _slice(dense.bias, 0, rank, size)}
    elif isinstance(dense, LoRADense):
        if style == "row" and dense.bias is not None:
            raise ValueError("a row-parallel projection with a bias is not supported")
        n_out, n_in = dense.weight.shape
        out_f, in_f = (n_out // size, n_in) if style == "col" else (n_out, n_in // size)
        with torch.device("meta"):
            shard = LoRADense(in_f, out_f, bias=dense.bias is not None,
                              lora_rank=dense.lora_rank, lora_dropout=dense.lora_dropout,
                              quantize=dense.quantized, dtype=dense.dtype)
        shard.dropout_key = dense.dropout_key
        if dense.lora_rank:
            shard.scaling = dense.scaling
        wdim = 0 if style == "col" else 1
        tensors = {"weight": _slice(dense.weight, wdim, rank, size)}
        if dense.quantized:
            tensors["weight_scale"] = (_slice(dense.weight_scale, 0, rank, size)
                                       if style == "col"
                                       else dense.weight_scale.detach().clone())
        if dense.bias is not None:
            tensors["bias"] = _slice(dense.bias, 0, rank, size)
        if dense.lora_rank:
            a, b = dense.lora_A.weight, dense.lora_B.weight
            tensors["lora_A.weight"] = (a.detach().clone() if style == "col"
                                        else _slice(a, 1, rank, size))
            tensors["lora_B.weight"] = (_slice(b, 0, rank, size) if style == "col"
                                        else b.detach().clone())
    else:
        if dense.weight.dtype == torch.int8:
            raise ValueError("tensor parallelism of an int8 UNet layer is not supported")
        col = style == "col"
        n_out, n_in = dense.weight.shape[:2]
        shard = _new_like(dense, n_out // size if col else n_out, n_in if col else n_in // size)
        tensors = {"weight": _slice(dense.weight, 0 if col else 1, rank, size, chunks)}
        if dense.bias is not None:
            tensors["bias"] = (_slice(dense.bias, 0, rank, size, chunks) if col
                               else dense.bias.detach().clone())
    shard.tp = spec
    originals = dict(dense.named_parameters())
    for name, value in tensors.items():
        owner = shard
        *path, leaf = name.split(".")
        for part in path:
            owner = getattr(owner, part)
        setattr(owner, leaf, nn.Parameter(value.to(device),
                                          requires_grad=originals[name].requires_grad))
    return shard


def split_embedding(emb: nn.Embedding, rank: int, size: int, group=None) -> nn.Embedding:
    """The row shard ``rank`` of ``size`` of an ``nn.Embedding`` (its
    table's rows ``[rank n / size, (rank + 1) n / size)``) as a new
    embedding that records its ``TPSpec`` in ``tp`` (style "col": the
    table's dim 0 is split, as a column shard's weight) and keeps the
    trainable flag. ``LlamaModel.embed`` looks up the ids a shard owns and
    adds the shards' rows over ``group``."""
    n, dim = emb.weight.shape
    with torch.device("meta"):
        shard = nn.Embedding(n // size, dim, dtype=emb.weight.dtype)
    shard.weight = nn.Parameter(_slice(emb.weight, 0, rank, size),
                                requires_grad=emb.weight.requires_grad)
    shard.tp = TPSpec("col", rank, size, group)
    return shard


def split_vocab_(llm: nn.Module, rank: int, size: int, group=None) -> bool:
    """In place: a ``LlamaForCausalLM``'s ``embed_tokens`` becomes its row
    shard (:func:`split_embedding`) and its ``lm_head`` its column shard
    (:func:`split_dense`) over ``group``: the JAX ``("vocab", "model")``
    rule. A ``vocab_padded`` that does not divide ``size`` keeps both whole,
    with a warning, as the JAX package replicates such a dim. Returns
    whether the vocabulary was split."""
    n = llm.cfg.vocab_padded
    if n % size:
        # loud: two whole 7B tables on every model rank are memory the
        # user cannot diagnose from behavior alone
        logger.warning("sharding fallback: vocab_padded (%d) does not divide mesh axis model "
                       "(size %d); embed_tokens and lm_head kept whole on every model rank",
                       n, size)
        return False
    llm.model.embed_tokens = split_embedding(llm.model.embed_tokens, rank, size, group)
    llm.lm_head = split_dense(llm.lm_head, "col", rank, size, group)
    return True


def tp_split_dim(leaf: str, style: str) -> Optional[int]:
    """The dim along which a ``split_dense`` shard of ``style`` holds a
    slice of its parameter ``leaf`` (None: the shard holds it whole)."""
    col = style == "col"
    if leaf == "weight":
        return 0 if col else 1
    if leaf in ("weight_scale", "bias", "lora_B.weight"):
        return 0 if col else None
    if leaf == "lora_A.weight":
        return None if col else 1
    return None


def tp_splits(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """{parameter name: (split dim, chunks)} of the parameters of which the
    ``split_dense`` shards in ``model`` hold a slice (the checkpoint's
    gather map)."""
    out = {}
    for path, module in model.named_modules():
        spec = getattr(module, "tp", None)
        if not isinstance(spec, TPSpec):
            continue
        for leaf, _ in module.named_parameters():
            if (d := tp_split_dim(leaf, spec.style)) is not None:
                out[f"{path}.{leaf}" if path else leaf] = (d, spec.chunks)
    return out


def _split_children_(parent: nn.Module, styles: Dict[str, str], rank: int, size: int,
                     group) -> None:
    """In place: each child of ``parent`` named in ``styles`` (a dotted
    path) becomes its ``split_dense`` shard; GEGLU's ``net.0.proj`` in its
    two halves (``[h | gate]``)."""
    for path, style in styles.items():
        owner_path, _, leaf = path.rpartition(".")
        owner = parent.get_submodule(owner_path)
        setattr(owner, leaf, split_dense(getattr(owner, leaf), style, rank, size, group,
                                         chunks=2 if path == "net.0.proj" else 1))


# the UNet's Megatron split: layer kind -> {child path: style}
UNET_TP_STYLES = {
    "attention": {"to_q": "col", "to_k": "col", "to_v": "col", "to_out.0": "row"},
    "feed_forward": {"net.0.proj": "col", "net.2": "row"},
    "resnet": {"conv1": "col", "time_emb_proj": "col", "norm2": "col", "conv2": "row"},
    "time_embedding": {"linear_1": "col", "linear_2": "row"},
}


def split_unet_(unet: nn.Module, rank: int, size: int, group=None) -> List[str]:
    """In place: the Megatron shard ``rank`` of ``size`` of an SDXL
    ``UNet2DConditionModel`` (the split of :data:`UNET_TP_STYLES`, described
    at the top of this module). An attention whose heads, or a feed-forward
    or time embedding whose width, do not divide ``size`` stays whole, with
    a warning, as the JAX package replicates a dim that does not divide its
    mesh axis; a ResNet whose GroupNorm groups do not divide it raises.
    Returns the paths of the layers kept whole."""
    from ..models.sdxl.unet import (CrossAttention, FeedForwardGEGLU, ResnetBlock2D,
                                    TimestepEmbedding)

    plan = []
    for path, m in unet.named_modules():
        if isinstance(m, CrossAttention):
            plan.append((path, m, "attention", m.to_q.weight.shape[0] // m.dim_head, "heads"))
        elif isinstance(m, FeedForwardGEGLU):
            plan.append((path, m, "feed_forward", m.net[2].weight.shape[1], "inner width"))
        elif isinstance(m, TimestepEmbedding):
            plan.append((path, m, "time_embedding", m.linear_1.weight.shape[0], "width"))
        elif isinstance(m, ResnetBlock2D):
            if m.norm2.num_groups % size:
                raise ValueError(f"tensor parallelism: {path}.norm2 has {m.norm2.num_groups} "
                                 f"GroupNorm groups; a split of {size} would cut a group")
            plan.append((path, m, "resnet", m.norm2.num_groups, "GroupNorm groups"))
    kept = []
    for path, m, kind, n, what in plan:
        if n % size:
            # loud: a layer held whole on every model rank is memory and
            # traffic the user cannot diagnose from behavior alone
            logger.warning("sharding fallback: %s %s (%d) do not divide mesh axis model "
                           "(size %d); kept whole on every model rank", path, what, n, size)
            kept.append(path)
            continue
        _split_children_(m, UNET_TP_STYLES[kind], rank, size, group)
    return kept


def apply_tensor_parallel_(model: nn.Module, group) -> Dict[str, Tuple[int, int]]:
    """In place: every LLaMA projection of ``model`` becomes this rank's
    ``split_dense`` shard over ``group``, every LLaMA's vocabulary its
    :func:`split_vocab_` shards, and every UNet of it its
    :func:`split_unet_` shard. Returns :func:`tp_splits`."""
    from ..models.llama import LlamaForCausalLM
    from ..models.sdxl.unet import UNet2DConditionModel

    rank, size = dist.get_rank(group), dist.get_world_size(group)
    for parent in list(model.modules()):
        for child_name, child in list(parent.named_children()):
            if child_name in TP_STYLES and hasattr(child, "lora_rank"):
                setattr(parent, child_name, split_dense(child, TP_STYLES[child_name], rank,
                                                        size, group))
    for llm in [m for m in model.modules() if isinstance(m, LlamaForCausalLM)]:
        split_vocab_(llm, rank, size, group)
    for unet in [m for m in model.modules() if isinstance(m, UNet2DConditionModel)]:
        split_unet_(unet, rank, size, group)
    return tp_splits(model)


# -- FSDP ----------------------------------------------------------------------


def _unit_types():
    from ..models.llama import LlamaDecoderLayer, LlamaForCausalLM, LlamaModel
    from ..models.sdxl.unet import BasicTransformerBlock, Downsample2D, ResnetBlock2D, Upsample2D

    blocks = (LlamaDecoderLayer, ResnetBlock2D, BasicTransformerBlock, Downsample2D, Upsample2D)
    return blocks, (LlamaModel, LlamaForCausalLM)


def apply_fsdp_(model: nn.Module, data_mesh) -> set:
    """``fully_shard`` over the 1-D ``data_mesh`` on each LLaMA decoder
    layer and UNet block (``ResnetBlock2D``, ``BasicTransformerBlock``,
    ``Downsample2D``, ``Upsample2D``), each direct child with parameters of
    the LLaMA modules and of ``model`` (the towers: ViT, resamplers,
    embeddings, norm, ``lm_head``; the adapter's resampler and the rest of
    its UNet), then on ``model``; children before their parents. Every
    method the losses call then reaches its parameters through a unit's own
    forward, and a forward gathers one block at a time.

    Returned, and kept outside FSDP: the int8 weights of a
    ``quantize_base`` base and their scales, held as this rank's dim-0
    slices (:func:`shard_int8_base_`; FSDP cannot hold integer
    parameters); any other integer parameter, whole; and the trainable
    parameters of another dtype than the most common one of their unit (an
    f32 RMSNorm or LayerNorm beside bf16 LoRA: FSDP wants one dtype among a
    unit's trainable parameters), whole, their gradients averaged over
    ``data`` as under ``dp``."""
    from torch.distributed.fsdp import fully_shard

    from ..models.llama import LoRADense

    layer_t, llama_t = _unit_types()
    units = set()
    for m in model.modules():
        if isinstance(m, layer_t):
            units.add(m)
        if m is model or isinstance(m, llama_t):
            units.update(c for c in m.children() if any(True for _ in c.parameters())
                         and not isinstance(c, (nn.ModuleList, nn.ModuleDict)))
    base = [m for m in model.modules() if isinstance(m, LoRADense) and m.quantized]
    held = {p for m in base for p in (m.weight, m.weight_scale)}
    whole = _minority_dtype_params(model, units)
    whole |= {p for p in model.parameters() if not p.is_floating_point() and p not in held}
    for name in padded_by_fsdp(model, whole, data_mesh.size()):
        # loud: a padded 7B dim is memory and traffic the user cannot
        # diagnose from behavior alone
        logger.warning("sharding: %s dim 0 does not divide mesh axis data (size %d); it is "
                       "padded to a multiple of it", name, data_mesh.size())
    shard_int8_base_(base, data_mesh)
    ignored = whole | {p for m in base for p in (m.weight, m.weight_scale)}
    for m in [m for m in reversed(list(model.modules())) if m in units]:
        fully_shard(m, mesh=data_mesh, ignored_params=ignored)
    fully_shard(model, mesh=data_mesh, ignored_params=ignored)
    return ignored


@dataclasses.dataclass(frozen=True)
class DataShard:
    """An int8 ``LoRADense``'s weight and scale held over ``data``: this
    rank's rows ``[rank c, (rank + 1) c)`` of the ``rows`` of each, ``c`` =
    ceil(rows / size), the last ranks' zero-padded to ``c`` (FSDP2's dim-0
    shard); ``group`` is the data group the product gathers them over."""

    rows: int
    group: object


def _padded(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows after its own, ``rows`` in all."""
    out = t.new_zeros((rows, *t.shape[1:]))
    out[:t.shape[0]] = t.detach()
    return out


def row_slice(t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rows ``[rank c, (rank + 1) c)`` of ``t``, ``c`` = ceil(rows / size),
    zero-padded to ``c`` rows: FSDP2's dim-0 shard of ``t``."""
    c = -(-t.shape[0] // size)
    return _padded(t[rank * c:(rank + 1) * c], c)


def shard_int8_base_(base: list, data_mesh) -> None:
    """In place: each int8 ``LoRADense`` of ``base`` keeps only this data
    rank's :func:`row_slice` of its weight and scale (both frozen) and
    records its :class:`DataShard` in ``data_shard``; its product gathers
    them (``models/llama.py::LoRADense.forward``). Nothing changes at one
    data rank."""
    size = data_mesh.size()
    if size == 1:
        return
    rank, group = data_mesh.get_local_rank(), data_mesh.get_group()
    for m in base:
        rows = m.weight.shape[0]
        for leaf in ("weight", "weight_scale"):
            setattr(m, leaf, nn.Parameter(row_slice(getattr(m, leaf), rank, size),
                                          requires_grad=False))
        m.data_shard = DataShard(rows, group)


def data_splits(model: nn.Module) -> Dict[str, int]:
    """{parameter name: whole rows} of the parameters held as data-rank row
    slices by :func:`shard_int8_base_` (the checkpoint's gather map, beside
    :func:`tp_splits`)."""
    out = {}
    for path, module in model.named_modules():
        shard = getattr(module, "data_shard", None)
        if isinstance(shard, DataShard):
            for leaf in ("weight", "weight_scale"):
                out[f"{path}.{leaf}" if path else leaf] = shard.rows
    return out


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


def full_tensor(local: torch.Tensor, like: torch.Tensor,
                tp_split: Optional[Tuple[int, int]] = None, tp_group=None,
                data_rows: Optional[int] = None, data_group=None) -> torch.Tensor:
    """The whole parameter of which ``local`` is this rank's piece: laid
    out like ``like`` (a DTensor parameter of FSDP: dim 0 sharded over its
    1-D mesh, rank r holding rows ``[r c, (r + 1) c)`` but the last ranks
    fewer; a plain one: ``local`` itself), or with ``data_rows`` the
    :func:`row_slice` of each rank of ``data_group``; each joined with one
    plain all-gather (which gloo also takes on CUDA tensors) and cut to the
    whole rows. Then joined over ``tp_group`` along the dim of ``tp_split``
    = (dim, chunks) (each rank's piece holding its slice of each of
    ``chunks`` blocks, :func:`_slice`). A collective: every rank calls it
    in the same order."""
    from .collectives import gather_rows

    t = local
    if is_dtensor(like):
        group = _dim0_group(like)
        c = -(-like.shape[0] // dist.get_world_size(group))
        t = gather_rows(_padded(local, c), like.shape[0], group)
    if data_rows is not None and data_group is not None:
        t = gather_rows(t, data_rows, data_group)
    if tp_split is not None and tp_group is not None and dist.get_world_size(tp_group) > 1:
        dim, chunks = tp_split
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(tp_group))]
        dist.all_gather(parts, t.contiguous(), group=tp_group)
        blocks = [p.chunk(chunks, dim) for p in parts]
        t = torch.cat([b[c] for c in range(chunks) for b in blocks], dim=dim)
    return t


def _dim0_group(like: torch.Tensor):
    """The process group of a DTensor sharded along dim 0 over a 1-D mesh
    (FSDP2's layout); another layout raises."""
    from torch.distributed.tensor import Shard

    mesh = like.device_mesh
    if mesh.ndim != 1 or tuple(like.placements) != (Shard(0),):
        raise ValueError(f"a DTensor placed as {like.placements} over a {mesh.ndim}-D mesh: "
                         "the port's FSDP shards dim 0 over data only")
    return mesh.get_group()


def local_piece(full: torch.Tensor, like: torch.Tensor,
                tp_split: Optional[Tuple[int, int]] = None, tp_group=None,
                data_rows: Optional[int] = None, data_group=None) -> torch.Tensor:
    """The inverse of :func:`full_tensor`: this rank's piece of ``full``,
    for the local tensor of ``like``."""
    from torch.distributed.tensor import distribute_tensor

    t = full
    if tp_split is not None and tp_group is not None and dist.get_world_size(tp_group) > 1:
        t = _slice(t, tp_split[0], dist.get_rank(tp_group), dist.get_world_size(tp_group),
                   tp_split[1])
    if data_rows is not None and data_group is not None:
        t = row_slice(t, dist.get_rank(data_group), dist.get_world_size(data_group))
    if is_dtensor(like):
        t = distribute_tensor(t.to(like.device), like.device_mesh, like.placements,
                              src_data_rank=None).to_local()
    return t
