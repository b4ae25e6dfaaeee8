"""Linear and LayerNorm under the JAX package's dtype policy: flax ``Dense``
computes in the module's ``dtype`` with its parameters cast to it, and
``LayerNorm`` takes f32 statistics and casts its output to ``dtype``.

A Linear whose weight is int8 (an int8 UNet's ``QDense``, after
``quantize_unet_``) carries a per-output-channel ``weight_scale`` and runs
``int8_linear``: the product rounded, times the scale rounded, then the bias
(``seed_story_tpu/models/sdxl/unet.py:63-77``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .int8_linear import int8_linear


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    if layer.weight.dtype == torch.int8:
        y = int8_linear(x.to(dtype), layer.weight, layer.weight_scale)
        return y if bias is None else y + bias
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(dtype)
