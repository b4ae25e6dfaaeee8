"""Linear and LayerNorm under the JAX package's dtype policy: flax ``Dense``
computes in the module's ``dtype`` with its parameters cast to it, and
``LayerNorm`` takes f32 statistics and casts its output to ``dtype``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(dtype)
