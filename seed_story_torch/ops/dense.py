"""Linear and LayerNorm under the JAX package's dtype policy: flax ``Dense``
computes in the module's ``dtype`` with its parameters cast to it, and
``LayerNorm`` takes f32 statistics and casts its output to ``dtype``.

A Linear whose weight is int8 (an int8 UNet's ``QDense``, after
``quantize_unet_``) carries a per-output-channel ``weight_scale`` and runs
``int8_linear``: the product rounded, times the scale rounded, then the bias
(``seed_story_tpu/models/sdxl/unet.py:63-77``).

A layer that is a tensor-parallel shard (``parallel/sharding.py::split_dense``
records its ``tp``) joins the other shards of its group: a column shard takes
the whole input, its gradient summed over the group; a row shard's partial
outputs are summed over the group, then the bias is added once."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to_group, reduce_from_group
from .int8_linear import int8_linear


def sharded(product, layer: nn.Module, x: torch.Tensor, bias):
    """``product(x, bias)`` of a layer, joined over its tensor-parallel
    group when it is a shard (its ``tp`` names a group): a column shard's
    input gradient is summed over the group, a row shard's output is summed
    over it before the bias."""
    tp = getattr(layer, "tp", None)
    if tp is None or tp.group is None:
        return product(x, bias)
    if tp.style == "col":
        return product(copy_to_group(x, tp.group), bias)
    y = reduce_from_group(product(x, None), tp.group)
    return y if bias is None else y + bias


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    if layer.weight.dtype == torch.int8:
        y = int8_linear(x.to(dtype), layer.weight, layer.weight_scale)
        return y if bias is None else y + bias
    return sharded(lambda xs, b: F.linear(xs, layer.weight.to(dtype), b), layer, x.to(dtype),
                   bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(dtype)
