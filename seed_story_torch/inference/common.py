"""Assembly of the story stack (tokenizer, ViT, agent, SDXL adapter + VAE)
from config dataclasses and a weights source, and the helpers of the two
inference CLIs; counterpart of ``seed_story_tpu/inference/common.py``.

Weights come either from seeded random initialisation on the device
(``weights=None``), or from the JAX package's parameter trees
(``weights={"vit": ..., "agent": ..., "adapter": ..., "vae": ...}``), and
then from the port's own parameter files (``save_params`` or a training
checkpoint directory) through ``vit_ckpt``, ``agent_ckpt``, ``adapter_ckpt``
and ``vae_ckpt``, the CLIs' ``--*_ckpt`` flags (``train/checkpoint.py::
load_checkpoint_``: float entries load before a quantization, int8 entries
after it). ``sdxl_int8`` is the int8 UNet: the adapter is filled float and
its UNet quantized in place (``quantize_adapter_``).
The de-tokenizer returns uint8 (H, W, 3) arrays. The flagship decode
configuration is ``quantize_base`` (the float agent is quantized in place
after it is filled), ``quantize_kv`` and ``speculate_k``. The generator
hands its KV cache back for the sink flows (``sink``) and for the one-story
flow without speculation; the lockstep and pipelined serving flows
re-prefill every segment and keep no cache (the JAX package's rule).
``build_stack_from_yaml`` is the CLIs' front end: the repo's YAML configs
through ``utils/config.py`` and ``train_clm_sft.port_config``. PIL is
imported only where a subtitle is drawn.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..data.tokenizer import TinyTokenizer
from .. import weights as W
from ..decode.generate import GenerateConfig, StoryGenerator
from ..models.agent import AgentConfig, ContinuousLVLM
from ..models.llama import quantize_llama_
from ..models.sdxl.adapter import SDXLAdapter, SDXLAdapterConfig, quantize_adapter_
from ..models.sdxl.vae import AutoencoderKL, VAEConfig
from ..models.vit import ViTConfig, VisionTransformerWithAttnPool
from ..parallel.mesh import make_mesh
from ..pipelines.sdxl_pipeline import SDXLImagePipeline, SDXLSampleConfig
from ..train.checkpoint import load_checkpoint_
from ..utils.config import instantiate, load_config


def read_jsonl(path: str):
    data = []
    with open(path) as f:
        for line in f:
            if line.strip():
                data.append(json.loads(line))
    return data


def split_subtitle(text: str) -> tuple:
    """Two lines, split at the word boundary nearest the midpoint."""
    mid = len(text) // 2
    left = text.rfind(" ", 0, mid + 1)
    right = text.find(" ", mid)
    if left == -1 and right == -1:
        return text[:mid], text[mid:]
    if left == -1 or (right != -1 and right - mid < mid - left):
        cut = right
    else:
        cut = left
    return text[:cut], text[cut + 1:]


def add_subtitle(original_image, text: str):
    """A PIL image with a black caption bar of two lines under the frame."""
    from PIL import Image, ImageDraw

    text_height = 80
    new_image = Image.new("RGB", (original_image.width, original_image.height + text_height),
                          "black")
    new_image.paste(original_image, (0, 0))
    draw = ImageDraw.Draw(new_image)
    font_size = 14
    line1, line2 = split_subtitle(text)
    y1 = original_image.height + (text_height - font_size) // 2
    draw.text((10, y1), line1, fill="white")
    draw.text((10, y1 + font_size), line2, fill="white")
    return new_image


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
    image_transform: Optional[Callable] = None  # PIL image -> (3, H, W) float32
    # device -> (feats -> uint8 image): a de-tokenizer replica whose weights
    # live on that device (the DetokenizerPool factory of pipelines/serving.py);
    # None without an adapter
    detok_factory: Optional[Callable] = None
    device: Optional[torch.device] = None


def _indexed(device) -> torch.device:
    """``device`` with its index: "cuda" is the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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
                sink: bool = False, batch_stories: int = 1,
                pipelined_detok: bool = False,
                image_transform: Optional[Callable] = None, sdxl_int8: bool = False,
                vit_ckpt: Optional[str] = None, agent_ckpt: Optional[str] = None,
                adapter_ckpt: Optional[str] = None,
                vae_ckpt: Optional[str] = None, decode_tp: int = 0) -> InferenceStack:
    """The gen_george stack (and, with ``sink``, the sink flows'). ``weights``:
    None for seeded random weights, or the JAX (float) param trees by family;
    the ``*_ckpt`` parameter files then overwrite what they hold (a float
    agent checkpoint before ``quantize_base`` quantizes, an int8 one after).
    ``sdxl_int8`` (or ``adapter_cfg.unet.quantize``) quantizes the filled
    adapter's UNet in place, after a float ``adapter_ckpt`` loads.
    ``eos_token_id=-1`` bans EOS (every segment decodes ``max_new_tokens``).
    ``quantize_base`` quantizes the filled float agent in place,
    ``quantize_kv`` gives its caches int8 rows. The generator keeps the KV
    cache (``return_cache``) for ``sink``, or for one story
    (``batch_stories`` <= 1) decoded inline without speculation; with
    ``pipelined_detok`` the stack has no inline de-tokenizer and the pool's
    replicas come from ``detok_factory``. Every image starts from the same
    noise (seed 42, the JAX pipeline's default). ``decode_tp`` > 1 decodes
    tensor-parallel over the first ``decode_tp`` visible devices, the rest
    of the stack staying on ``device`` (``decode/tensor_parallel.py``)."""
    weights = weights or {}
    tokenizer = tokenizer or TinyTokenizer()
    device = _indexed(device)

    vit = _build(VisionTransformerWithAttnPool, vit_cfg, device, seed,
                 weights.get("vit"), W.vit_state_dict)
    load_checkpoint_(vit, vit_ckpt)

    @torch.inference_mode()
    def visual_encode(pixels):
        return vit(torch.as_tensor(np.asarray(pixels, np.float32), device=device))

    agent = _build(ContinuousLVLM, agent_cfg, device, seed + 1, weights.get("agent"),
                   W.agent_state_dict)
    load_checkpoint_(agent, agent_ckpt, (lambda a: quantize_agent_(
        a, base=quantize_base, kv=quantize_kv)) if quantize_base or quantize_kv else None)
    mesh = None
    if decode_tp > 1:
        # over the FIRST decode_tp devices; the tail ones stay free for replicas
        mesh = make_mesh(1, decode_tp, visible_devices(device)[:decode_tp])
    generator = StoryGenerator(agent, GenerateConfig(
        max_new_tokens=max_new_tokens, num_img_gen_tokens=agent_cfg.num_img_out_tokens,
        eos_token_id=eos_token_id, cache_capacity=cache_capacity, force_boi_at=force_boi_at,
        temperature=temperature, top_p=top_p, speculate_k=speculate_k,
        return_cache=sink or (batch_stories <= 1 and not pipelined_detok
                              and speculate_k == 0)), mesh=mesh)

    stack = InferenceStack(tokenizer=tokenizer, visual_encode=visual_encode,
                           generator=generator, detokenize=None,
                           num_img_in_tokens=agent_cfg.num_img_in_tokens, vit=vit, agent=agent,
                           image_transform=image_transform, device=device)
    if adapter_cfg is None:
        return stack

    vae_cfg = vae_cfg or VAEConfig(dtype=adapter_cfg.unet.dtype)
    int8_unet = sdxl_int8 or adapter_cfg.unet.quantize
    float_cfg = dataclasses.replace(adapter_cfg, unet=dataclasses.replace(adapter_cfg.unet,
                                                                          quantize=False))
    adapter = _build(SDXLAdapter, float_cfg, device, seed + 2, weights.get("adapter"),
                     W.adapter_state_dict)
    load_checkpoint_(adapter, adapter_ckpt, quantize_adapter_ if int8_unet else None)
    vae = _build(AutoencoderKL, vae_cfg, device, seed + 3, weights.get("vae"),
                 W.vae_state_dict)
    load_checkpoint_(vae, vae_ckpt)
    if device.type == "cuda":
        adapter.to(memory_format=torch.channels_last)
        vae.to(memory_format=torch.channels_last)
    sample_cfg = SDXLSampleConfig(height=image_size, width=image_size,
                                  num_inference_steps=num_inference_steps,
                                  vae_scale=2 ** (len(vae_cfg.block_out_channels) - 1))
    pipe = SDXLImagePipeline(adapter, vae, cfg=sample_cfg)
    # CFG negatives: the ViT features of a black image
    black = np.zeros((1, 3, vit_cfg.image_size, vit_cfg.image_size), np.float32)
    neg_feats = visual_encode(black)

    def detokenizer(rpipe, rdevice, rneg):
        def detokenize(feats):
            gen = torch.Generator(device=rdevice).manual_seed(42)
            return rpipe.generate(feats, rneg, generator=gen)[0]
        return detokenize

    def detok_factory(replica_device):
        """A replica on ``replica_device``: the stack's own adapter and VAE
        on the stack's device, copies of them on another."""
        replica_device = _indexed(replica_device)
        if replica_device == device:
            return detokenizer(pipe, device, neg_feats)
        rpipe = SDXLImagePipeline(copy.deepcopy(adapter).to(replica_device),
                                  copy.deepcopy(vae).to(replica_device), cfg=sample_cfg)
        return detokenizer(rpipe, replica_device, neg_feats.to(replica_device))

    stack.image_pipe, stack.detok_factory = pipe, detok_factory
    if not pipelined_detok:
        stack.detokenize = detokenizer(pipe, device, neg_feats)
    return stack


def check_devices(args, devices) -> None:
    """Raises SystemExit when the CLI's device flags ask for more devices
    than ``devices``: ``--decode_tp`` decodes over the first N (a 1 x N mesh
    larger than the devices is refused, as the JAX ``make_mesh`` refuses
    it), and ``--detok_devices`` replicas take the last ones, never a
    decode device."""
    n_decode = max(args.decode_tp, 1)
    if n_decode > len(devices):
        raise SystemExit(f"--decode_tp {args.decode_tp}: mesh 1x{n_decode} > "
                         f"{len(devices)} devices")
    if args.detok_devices > 0 and n_decode + args.detok_devices > len(devices):
        raise SystemExit(f"--decode_tp {args.decode_tp} + --detok_devices "
                         f"{args.detok_devices} needs {n_decode + args.detok_devices} "
                         f"devices, have {len(devices)} (decode and SDXL replicas must not "
                         "share a device)")


def visible_devices(device) -> list:
    """The devices a CLI may spread over: every visible CUDA device for a
    CUDA ``device``, else ``device`` alone."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def build_stack_from_yaml(tokenizer_cfg: str, image_transform_cfg: str,
                          visual_encoder_cfg: str, llm_cfg_path: str, agent_cfg_path: str,
                          adapter_cfg_path: Optional[str] = None,
                          vae_cfg_path: Optional[str] = None, **kw) -> InferenceStack:
    """``build_stack`` from the repo's YAML configs, on seeded random weights
    or the ``*_ckpt`` parameter files in ``kw`` (the CLIs' front end). The
    tokenizer and transform YAMLs name the JAX
    package's builders, which ``utils.config`` maps onto the port's own; the
    model YAMLs name the JAX config classes, which ``port_config`` maps onto
    the port's. A LLaMA YAML's ``quantize_base`` / ``quantize_kv`` become the
    flagship decode configuration (the float agent quantized in place, an
    int8 KV cache). ``kw`` goes to ``build_stack``."""
    from ..train.train_clm_sft import port_config

    llm_raw = dict(load_config(llm_cfg_path))
    kw.setdefault("quantize_base", bool(llm_raw.pop("quantize_base", False)))
    kw.setdefault("quantize_kv", bool(llm_raw.pop("quantize_kv", False)))
    agent_cfg = port_config(load_config(agent_cfg_path), llm=port_config(llm_raw))
    adapter_cfg = port_config(load_config(adapter_cfg_path)) if adapter_cfg_path else None
    vae_cfg = None
    if adapter_cfg is not None:
        vae_cfg = (port_config(load_config(vae_cfg_path)) if vae_cfg_path
                   else VAEConfig(dtype=adapter_cfg.unet.dtype))
    return build_stack(port_config(load_config(visual_encoder_cfg)), agent_cfg, adapter_cfg,
                       vae_cfg, tokenizer=instantiate(load_config(tokenizer_cfg)),
                       image_transform=instantiate(load_config(image_transform_cfg)), **kw)
