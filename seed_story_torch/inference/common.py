"""Assembly of the story stack (tokenizer, ViT, agent, SDXL adapter + VAE)
from config dataclasses and a weights source; counterpart of
``build_stack`` in ``seed_story_tpu/inference/common.py``.

Weights come either from seeded random initialisation on the device
(``weights=None``), or from the JAX package's parameter trees
(``weights={"vit": ..., "agent": ..., "adapter": ..., "vae": ...}``).
The de-tokenizer returns uint8 (H, W, 3) arrays. The flagship decode
configuration is ``quantize_base`` (the float agent is quantized in place
after it is filled), ``quantize_kv`` and ``speculate_k``; ``sink`` keeps the
KV cache for the sink flows (``run_sink``, the visualization pipeline).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..data.tokenizer import TinyTokenizer
from .. import weights as W
from ..decode.generate import GenerateConfig, StoryGenerator
from ..models.agent import AgentConfig, ContinuousLVLM
from ..models.llama import quantize_llama_
from ..models.sdxl.adapter import SDXLAdapter, SDXLAdapterConfig
from ..models.sdxl.vae import AutoencoderKL, VAEConfig
from ..models.vit import ViTConfig, VisionTransformerWithAttnPool
from ..pipelines.sdxl_pipeline import SDXLImagePipeline, SDXLSampleConfig


@dataclasses.dataclass
class InferenceStack:
    tokenizer: Any
    visual_encode: Callable  # pixels (1, 3, H, W) -> (1, n, vit_dim) tensor
    generator: StoryGenerator
    detokenize: Optional[Callable]  # feats (1, n, D) -> uint8 (H, W, 3)
    num_img_in_tokens: int
    vit: VisionTransformerWithAttnPool
    agent: ContinuousLVLM
    image_pipe: Optional[SDXLImagePipeline] = None


def fill_module(cls, cfg, device, seed: int, params=None, to_state_dict=None) -> torch.nn.Module:
    """Creates the module on ``device`` and fills it: from the JAX ``params``
    (through ``to_state_dict``) when given, else from a seeded generator on
    the device. The module stays in training mode with gradients on."""
    with torch.device(device):
        module = cls(cfg)
    module.to(device)  # buffers made from numpy start on the host
    if params is None:
        W.init_random_(module, seed)
    else:
        module.load_state_dict(to_state_dict(module, params))
    return module


def _build(cls, cfg, device, seed: int, params, to_state_dict) -> torch.nn.Module:
    """A filled module, frozen for inference."""
    return fill_module(cls, cfg, device, seed, params, to_state_dict).eval().requires_grad_(False)


def quantize_agent_(agent: ContinuousLVLM, *, base: bool = True,
                    kv: bool = True) -> ContinuousLVLM:
    """In place: with ``base`` the agent's seven LLaMA projections become
    int8 (``quantize_llama_``, one projection at a time, so the transient
    peak is one projection's f32 copy); ``kv`` sets ``quantize_kv`` in the
    agent's configuration, which the generator reads for its caches. Both
    flags only switch on: a configuration that already asks for int8
    weights or an int8 cache keeps it."""
    if base:
        quantize_llama_(agent.llm)
    llm_cfg = dataclasses.replace(agent.cfg.llm, quantize_kv=agent.cfg.llm.quantize_kv or kv,
                                  quantize_base=agent.cfg.llm.quantize_base or base)
    agent.cfg = dataclasses.replace(agent.cfg, llm=llm_cfg)
    agent.llm.cfg = agent.llm.model.cfg = llm_cfg
    return agent


def build_stack(vit_cfg: ViTConfig, agent_cfg: AgentConfig,
                adapter_cfg: Optional[SDXLAdapterConfig] = None,
                vae_cfg: Optional[VAEConfig] = None, *, tokenizer=None,
                weights: Optional[Dict[str, Any]] = None, seed: int = 0,
                device="cuda", max_new_tokens: int = 500, cache_capacity: int = 4096,
                num_inference_steps: int = 50, image_size: int = 1024,
                force_boi_at: Optional[int] = None,
                eos_token_id: int = 2, quantize_base: bool = False,
                quantize_kv: bool = False, speculate_k: int = 0,
                temperature: float = 0.0, top_p: float = 1.0,
                sink: bool = False) -> InferenceStack:
    """The gen_george stack (and, with ``sink``, the sink flows'). ``weights``:
    None for seeded random weights, or the JAX param trees by family.
    ``eos_token_id=-1`` bans EOS (every segment decodes ``max_new_tokens``).
    ``quantize_base`` quantizes the filled float agent in place,
    ``quantize_kv`` gives its caches int8 rows. Every image starts from the
    same noise (seed 42, the JAX pipeline's default)."""
    weights = weights or {}
    tokenizer = tokenizer or TinyTokenizer()
    device = torch.device(device)

    vit = _build(VisionTransformerWithAttnPool, vit_cfg, device, seed,
                 weights.get("vit"), W.vit_state_dict)

    @torch.inference_mode()
    def visual_encode(pixels):
        return vit(torch.as_tensor(np.asarray(pixels, np.float32), device=device))

    agent = _build(ContinuousLVLM, agent_cfg, device, seed + 1, weights.get("agent"),
                   W.agent_state_dict)
    if quantize_base or quantize_kv:
        quantize_agent_(agent, base=quantize_base, kv=quantize_kv)
    generator = StoryGenerator(agent, GenerateConfig(
        max_new_tokens=max_new_tokens, num_img_gen_tokens=agent_cfg.num_img_out_tokens,
        eos_token_id=eos_token_id, cache_capacity=cache_capacity, force_boi_at=force_boi_at,
        temperature=temperature, top_p=top_p, speculate_k=speculate_k, return_cache=sink))

    stack = InferenceStack(tokenizer=tokenizer, visual_encode=visual_encode,
                           generator=generator, detokenize=None,
                           num_img_in_tokens=agent_cfg.num_img_in_tokens, vit=vit, agent=agent)
    if adapter_cfg is None:
        return stack

    vae_cfg = vae_cfg or VAEConfig(dtype=adapter_cfg.unet.dtype)
    adapter = _build(SDXLAdapter, adapter_cfg, device, seed + 2, weights.get("adapter"),
                     W.adapter_state_dict)
    vae = _build(AutoencoderKL, vae_cfg, device, seed + 3, weights.get("vae"),
                 W.vae_state_dict)
    if device.type == "cuda":
        adapter.to(memory_format=torch.channels_last)
        vae.to(memory_format=torch.channels_last)
    vae_scale = 2 ** (len(vae_cfg.block_out_channels) - 1)
    pipe = SDXLImagePipeline(adapter, vae, cfg=SDXLSampleConfig(
        height=image_size, width=image_size, num_inference_steps=num_inference_steps,
        vae_scale=vae_scale))
    # CFG negatives: the ViT features of a black image
    black = np.zeros((1, 3, vit_cfg.image_size, vit_cfg.image_size), np.float32)
    neg_feats = visual_encode(black)

    def detokenize(feats):
        gen = torch.Generator(device=device).manual_seed(42)
        return pipe.generate(feats, neg_feats, generator=gen)[0]

    stack.detokenize, stack.image_pipe = detokenize, pipe
    return stack
