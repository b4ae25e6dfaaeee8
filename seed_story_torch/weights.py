"""Weights for the port's modules: the JAX package's parameter trees
(nested dicts of numpy arrays) turned into ``state_dict``s, and seeded
random initialisation on the device.

One function per family: :func:`vit_state_dict` (the ViT with attention
pool, or the no-pool ``VisionTransformer``), :func:`agent_state_dict`
(LLaMA with LoRA plus the two resamplers, or the align agent's LLaMA and
output resampler), :func:`adapter_state_dict`
(ResamplerXLV2 plus the UNet, or the two latent-image edit adapters),
:func:`vae_state_dict`, :func:`discrete_state_dict` (the stage-1 discrete
models) and :func:`ipa_adapter_state_dict` (``IPAdapterSD``: its
``IPAResampler`` and SD-1.5-layout UNet, a bare IPA resampler, or an
``IPCrossAttention``). Each walks the
port module's own state-dict keys, finds the flax leaf each one came from,
and undoes the layout change ``seed_story_tpu/tools/convert_torch_weights.py``
makes: flax Dense kernels (in, out) become Linear weights (out, in), flax
Conv kernels HWIO become OIHW, norm ``scale`` becomes ``weight``; an int8
projection's ``kernel`` (int8, (in, out)) and ``kernel_scale`` become its
``weight`` (transposed) and ``weight_scale``, and so do an int8 UNet's
Linear and Conv2d weights (HWIO int8 -> OIHW). Padded vocab rows stay
padded. Every flax leaf must be used exactly once.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from .models.agent import ContinuousLVLM
from .models.discrete import DiscreteModelStageOneContrastive, VectorQuantizer
from .models.ipa_resampler import AttentionPool2d, IPAResampler, ResamplerXLV2
from .models.llama import LoRADense, RMSNorm, quantize_weight
from .models.resampler import MultiheadAttention, Resampler
from .models.vit import (VisionTransformer, VisionTransformerWithAttnPool, VisualAttention,
                         VisualMLP)
from .ops.groupnorm import FastGroupNorm

PathFn = Callable[[str], str]


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _leaf(module: nn.Module, key: str) -> Tuple[str, Callable[[np.ndarray], np.ndarray]]:
    """(flax leaf name, array transform) for the torch parameter ``key``."""
    prefix, _, name = key.rpartition(".")
    owner = module.get_submodule(prefix) if prefix else module
    if name == "weight":
        if isinstance(owner, (nn.Linear, LoRADense)):
            return "kernel", lambda w: w.T
        if isinstance(owner, nn.Conv2d):
            return "kernel", lambda w: np.transpose(w, (3, 2, 0, 1))
        if isinstance(owner, (nn.LayerNorm, FastGroupNorm)):
            return "scale", lambda w: w
        if isinstance(owner, nn.Embedding):
            return "embedding", lambda w: w
    if name == "weight_scale":  # an int8 projection or convolution
        return "kernel_scale", lambda w: w
    return name, lambda w: w


def _flax_paths(module: nn.Module, path_of: PathFn) -> Dict[str, Tuple[str, Callable]]:
    """Every state-dict key of ``module`` except the frozen sin-cos buffers ->
    (the flax leaf path it comes from, the flax -> torch array transform)."""
    out = {}
    for key in module.state_dict():
        if key.endswith("pos_embed"):  # frozen sin-cos buffer, not a flax param
            continue
        leaf, transform = _leaf(module, key)
        prefix = key.rpartition(".")[0]
        path = path_of(prefix)
        if path.endswith(("/lora_A", "/lora_B")):  # PEFT pair -> flax lora_a / lora_b
            path = path[:-len("lora_A")] + path[-len("lora_A"):].lower()
        else:
            path = f"{path}/{leaf}" if path else leaf
        out[key] = (path, transform)
    return out


def _state_dict(module: nn.Module, params, path_of: PathFn) -> Dict[str, torch.Tensor]:
    flat = _flatten(params)
    unused = set(flat)
    paths = _flax_paths(module, path_of)
    sd = {}
    for key, ref in module.state_dict().items():
        if key not in paths:
            sd[key] = ref
            continue
        path, transform = paths[key]
        if path not in flat:
            raise KeyError(f"{key}: no flax leaf {path}")
        value = np.ascontiguousarray(transform(flat[path]))
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax {path} has shape {value.shape}, module wants "
                             f"{tuple(ref.shape)}")
        sd[key] = torch.tensor(value, dtype=ref.dtype, device=ref.device)
        unused.discard(path)
    if unused:
        raise KeyError(f"flax leaves with no module parameter: {sorted(unused)[:8]}")
    return sd


def _dotted(prefix: str) -> str:
    return prefix.replace(".", "/")


def _llama_path(prefix: str) -> str:
    return _dotted(re.sub(r"layers\.(\d+)", r"layers_\1", prefix))


def _vit_path(prefix: str) -> str:
    prefix = re.sub(r"transformer\.resblocks\.(\d+)\.(mlp\.)?", r"blocks_\1.", prefix)
    return _dotted(prefix)


def _diffusers_path(prefix: str) -> str:
    """diffusers module path -> the JAX module path (the inverse of
    convert_torch_weights._diffusers_path): indices join their names, a
    block index joins its sub-list, GEGLU's proj joins ``net_0``."""
    prefix = re.sub(r"\.(\d+)", r"_\1", prefix)
    prefix = re.sub(r"((?:down_blocks|up_blocks)_\d+|mid_block)\.", r"\1_", prefix)
    prefix = prefix.replace("ff.net_0.proj", "ff.net_0_proj")
    return _dotted(prefix)


def _vae_path(prefix: str) -> str:
    path = _diffusers_path(prefix)
    return re.sub(r"((?:up|down)samplers_\d+)/conv", r"\1_conv", path)


def _ipa_path(prefix: str) -> str:
    prefix = re.sub(r"layers\.(\d+)\.0", r"layers_\1_attn", prefix)
    prefix = re.sub(r"layers\.(\d+)\.1\.0", r"layers_\1_ff.norm", prefix)
    prefix = re.sub(r"layers\.(\d+)\.1\.1", r"layers_\1_ff.fc1", prefix)
    prefix = re.sub(r"layers\.(\d+)\.1\.3", r"layers_\1_ff.fc2", prefix)
    prefix = re.sub(r"unet_attnpool\.(\w+_proj)", r"unet_attnpool.attn.\1", prefix)
    return _dotted(prefix)


def vit_state_dict(module: VisionTransformer, params) -> Dict[str, torch.Tensor]:
    """JAX ``VisionTransformerWithAttnPool`` (or no-pool ``VisionTransformer``)
    params -> the port's state dict of the same model."""
    return _state_dict(module, params, _vit_path)


def agent_state_dict(module: nn.Module, params) -> Dict[str, torch.Tensor]:
    """JAX ``ContinuousLVLM`` params (``llm``, ``input_resampler``,
    ``output_resampler``) -> the port's state dict. The align agent
    (``SEEDLLaMAAlignGeneration``: ``llm``, ``output_resampler``) and the
    parts (a bare ``LlamaForCausalLM``, a ``Resampler``) map the same way."""
    return _state_dict(module, params, _llama_path)


def agent_flax_paths(module: nn.Module) -> Dict[str, Tuple[str, Callable]]:
    """Parameter name of the port's agent (or its parts) -> (flax leaf path
    joined with '/', transform), as :func:`agent_state_dict` pairs them; used
    to hold gradients and trainable sets to the JAX package's. The agent's
    transforms are transposes or identities, so each is its own inverse."""
    return _flax_paths(module, _llama_path)


def _adapter_path(prefix: str) -> str:
    if prefix.startswith("resampler"):
        return _ipa_path(prefix)
    return _diffusers_path(prefix)


def adapter_state_dict(module, params) -> Dict[str, torch.Tensor]:
    """JAX ``SDXLAdapter`` params (``resampler``, ``unet``) -> state dict; the
    two latent-image edit adapters' (``SDXLAdapterWithLatentImage``,
    ``SD21Text2ImageAndEditAdapter`` with its optional ``resampler``) map
    the same way."""
    return _state_dict(module, params, _adapter_path)


def adapter_flax_paths(module: nn.Module) -> Dict[str, Tuple[str, Callable]]:
    """Parameter name of the port's ``SDXLAdapter`` (or an edit adapter) ->
    (flax leaf path joined with '/', the flax -> torch transform), as
    :func:`adapter_state_dict` pairs them; used to hold gradients and the
    trainable sets to the JAX package's."""
    return _flax_paths(module, _adapter_path)


def _ipa_adapter_path(prefix: str) -> str:
    if prefix.partition(".")[0] == "unet" or prefix.startswith("to_"):  # IPCrossAttention
        return _diffusers_path(prefix)
    return _ipa_path(prefix)


def ipa_adapter_state_dict(module: nn.Module, params) -> Dict[str, torch.Tensor]:
    """JAX ``IPAdapterSD`` params (``image_proj_model``, ``unet``) -> the
    port's state dict; a bare ``IPAResampler``'s and an ``IPCrossAttention``'s
    (``to_q`` ... ``to_v_ip``, ``to_out_0``) map the same way."""
    return _state_dict(module, params, _ipa_adapter_path)


def ipa_adapter_flax_paths(module: nn.Module) -> Dict[str, Tuple[str, Callable]]:
    """Parameter name of the port's ``IPAdapterSD`` -> (flax leaf path, the
    flax -> torch transform), to hold gradients to the JAX package's."""
    return _flax_paths(module, _ipa_adapter_path)


def discrete_state_dict(module: nn.Module, params) -> Dict[str, torch.Tensor]:
    """JAX discrete-model params (``encode_proj``, ``quantizer/codebook``,
    ``decode_proj``, the contrastive heads and ``logit_scale``, nested under
    ``distill`` / ``contrastive*`` in the composites) -> the port's state
    dict."""
    return _state_dict(module, params, _dotted)


def discrete_flax_paths(module: nn.Module) -> Dict[str, Tuple[str, Callable]]:
    """Parameter name of a port discrete model -> (flax leaf path,
    transform), to hold its gradients to the JAX package's."""
    return _flax_paths(module, _dotted)


def vae_state_dict(module, params) -> Dict[str, torch.Tensor]:
    """JAX ``AutoencoderKL`` params (encoder, ``quant_conv``, decoder,
    ``post_quant_conv``) -> the port's state dict."""
    return _state_dict(module, params, _vae_path)


# ---------------------------------------------------------------------------
# Seeded random initialisation, with the flax initialisers' scales.
# ---------------------------------------------------------------------------


def _lecun_(w: torch.Tensor, gen: torch.Generator):
    fan_in = w[0].numel()  # Linear (out, in) and Conv (out, in, kh, kw)
    w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)


def _xavier_(w: torch.Tensor, gen: torch.Generator):
    fan_out, fan_in = w.shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-a, a, generator=gen)


@torch.no_grad()
def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Fills every parameter of ``model`` in place from one generator on the
    parameters' device: lecun-normal projections and convolutions (flax's
    default), xavier-uniform where the JAX ViT and Qwen resamplers use it,
    normal(0.02) embeddings, LoRA A, resampler kv_proj and VQ codebooks, zero
    LoRA B and biases, unit norm scales, the JAX package's scales for learned
    queries and position tables, and log(1 / temperature) logit scales. Modules are visited children first, so a
    parent's rule overrides the generic one for its children."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for m in reversed(list(model.modules())):
        if isinstance(m, (nn.Linear, nn.Conv2d, LoRADense)):
            if m.weight.dtype == torch.int8:  # drawn in f32, then quantized
                w = torch.empty(m.weight.shape, dtype=torch.float32, device=device)
                _lecun_(w, gen)
                q, scale = quantize_weight(w)
                m.weight.copy_(q)
                m.weight_scale.copy_(scale)
            else:
                _lecun_(m.weight, gen)
            if m.bias is not None:
                m.bias.zero_()
        if isinstance(m, LoRADense) and m.lora_rank > 0:
            m.lora_A.weight.normal_(0.0, 0.02, generator=gen)
            m.lora_B.weight.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=gen)
        elif isinstance(m, (nn.LayerNorm, FastGroupNorm, RMSNorm)):
            m.weight.fill_(1.0)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, (VisualAttention, VisualMLP)):
            for child in m.children():
                _xavier_(child.weight, gen)
        elif isinstance(m, MultiheadAttention):
            _xavier_(m.in_proj_weight, gen)
            _xavier_(m.out_proj.weight, gen)
            m.in_proj_bias.zero_()
        elif isinstance(m, Resampler):
            m.query.normal_(0.0, 0.02, generator=gen).clamp_(-0.04, 0.04)
            if m.kv_proj is not None:
                m.kv_proj.weight.normal_(0.0, 0.02, generator=gen).clamp_(-0.04, 0.04)
        elif isinstance(m, VisionTransformer):
            m.positional_embedding.normal_(0.0, m.cfg.width ** -0.5, generator=gen)
            if isinstance(m, VisionTransformerWithAttnPool):
                m.proj.normal_(0.0, m.cfg.output_dim ** -0.5, generator=gen)
        elif isinstance(m, (ResamplerXLV2, IPAResampler)):
            m.latents.normal_(0.0, m.latents.shape[-1] ** -0.5, generator=gen)
        elif isinstance(m, VectorQuantizer):
            m.codebook.normal_(0.0, 0.02, generator=gen)
        elif isinstance(m, DiscreteModelStageOneContrastive):
            m.logit_scale.fill_(math.log(1.0 / m.temperature_init))
        elif isinstance(m, AttentionPool2d):
            m.positional_embedding.normal_(0.0, m.positional_embedding.shape[-1] ** -0.5,
                                           generator=gen)
    return model
