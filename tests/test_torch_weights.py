"""``seed_story_torch.weights``: JAX parameter trees into the port's state
dicts, checked by the round trip back through
``seed_story_tpu/tools/convert_torch_weights.py`` (which must reproduce the
JAX tree exactly); the seeded random initialisation; and that importing the
port pulls in none of jax, flax, yaml or PIL.

``jax_params`` is shared with the other ``test_torch_*`` files.
"""

import math
import pkgutil
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seed_story_torch
from seed_story_torch import weights as W
from seed_story_torch.models import agent as port_agent
from seed_story_torch.models.llama import LlamaConfig
from seed_story_torch.models.sdxl.adapter import SDXLAdapter, SDXLAdapterConfig
from seed_story_torch.models.sdxl.vae import AutoencoderKL, VAEConfig
from seed_story_torch.models.vit import VisionTransformerWithAttnPool, ViTConfig
from seed_story_tpu.models import agent as ref_agent
from seed_story_tpu.models import llama as ref_llama
from seed_story_tpu.models import vit as ref_vit
from seed_story_tpu.models.sdxl import adapter as ref_adapter
from seed_story_tpu.models.sdxl import vae as ref_vae
from seed_story_tpu.tools import convert_torch_weights as conv


def jax_params(module, *args, seed=0, **kwargs):
    """The flax ``module``'s parameter tree (shapes from ``init``, traced
    abstractly), filled from a seeded numpy generator at init-like scales.
    Biases and norm scales are random too, so a mix-up between parameters
    shows in the outputs."""
    shapes = nn.meta.unbox(jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))["params"])
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        x = rng.randn(*shape)
        if name == "scale" or (name == "weight" and len(shape) == 1):
            x = 1.0 + 0.1 * x
        elif name in ("bias", "in_proj_bias"):
            x = 0.1 * x
        elif name == "kernel":
            x = x / math.sqrt(np.prod(shape[:-1]))
        elif name in ("lora_a", "lora_b"):
            x = 0.1 * x / math.sqrt(shape[0])
        else:  # embeddings, queries, latents, position tables, fused in_proj
            x = x / math.sqrt(shape[-1])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def agent_init_args(jcfg, seq=64):
    return dict(
        input_ids=jnp.ones((1, seq), jnp.int32), attention_mask=jnp.ones((1, seq), jnp.int32),
        labels=jnp.zeros((1, seq), jnp.int32),
        image_embeds=jnp.zeros((1, jcfg.num_vit_tokens, jcfg.vit_dim)),
        embeds_gen_mask=jnp.ones((1,), bool), embeds_cmp_mask=jnp.ones((1,), bool),
        ids_gen_mask=jnp.zeros((1, seq), bool).at[0, 10:10 + jcfg.num_img_out_tokens].set(True),
        ids_cmp_mask=jnp.zeros((1, seq), bool).at[0, 30:30 + jcfg.num_img_in_tokens].set(True))


def adapter_init_args(lat=8, embed_dim=128):
    return dict(noisy_latents=jnp.zeros((1, lat, lat, 4)), timesteps=jnp.zeros((1,), jnp.int32),
                image_embeds=jnp.zeros((1, 9, embed_dim)), time_ids=jnp.ones((1, 6)),
                noise=jnp.zeros((1, lat, lat, 4)))


def _numpy_sd(module):
    return {k: v.detach().cpu().float().numpy() for k, v in module.state_dict().items()}


def _assert_same_tree(got, want, where=""):
    assert sorted(got) == sorted(want), (where, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_tree(got[k], want[k], f"{where}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=f"{where}/{k}")


def test_vit_round_trip():
    params = jax_params(ref_vit.VisionTransformerWithAttnPool(ref_vit.ViTConfig.tiny()),
                        jnp.zeros((1, 3, 56, 56)))
    vit = VisionTransformerWithAttnPool(ViTConfig.tiny(dtype=torch.float32))
    vit.load_state_dict(W.vit_state_dict(vit, params))
    back, missing, unexpected = conv.convert_qwen_vit(_numpy_sd(vit), layers=2)
    assert missing == [] and unexpected == []
    _assert_same_tree(back, params)


def test_agent_round_trip_keeps_lora_and_padded_vocab():
    llm = dict(lora_rank=4, num_key_value_heads=2)
    jcfg = ref_agent.AgentConfig.tiny(llm=ref_llama.LlamaConfig.tiny(dtype=jnp.float32, **llm))
    params = jax_params(ref_agent.ContinuousLVLM(jcfg), **agent_init_args(jcfg))
    agent = port_agent.ContinuousLVLM(port_agent.AgentConfig.tiny(
        llm=LlamaConfig.tiny(dtype=torch.float32, **llm)))
    sd = W.agent_state_dict(agent, params)
    assert sd["llm.model.embed_tokens.weight"].shape[0] == 32128  # padded rows stay
    assert sd["llm.model.layers.0.self_attn.q_proj.lora_A.weight"].shape == (4, 128)
    agent.load_state_dict(sd)
    back, missing, unexpected = conv.convert_agent(_numpy_sd(agent), num_layers=2)
    # the frozen sin-cos tables are taken and dropped: no flax parameter
    assert missing == [] and unexpected == []
    _assert_same_tree(back, params)


def test_adapter_and_vae_round_trip():
    jadapter = ref_adapter.SDXLAdapter(ref_adapter.SDXLAdapterConfig.tiny())
    params = jax_params(jadapter, **adapter_init_args())
    adapter = SDXLAdapter(SDXLAdapterConfig.tiny())
    adapter.load_state_dict(W.adapter_state_dict(adapter, params))
    back, _, _ = conv.convert_detokenizer(_numpy_sd(adapter))
    _assert_same_tree(back, params)

    vparams = jax_params(ref_vae.AutoencoderKL(ref_vae.VAEConfig.tiny()), jnp.zeros((1, 8, 8, 3)))
    vae = AutoencoderKL(VAEConfig.tiny())
    vae.load_state_dict(W.vae_state_dict(vae, vparams))
    assert {"encoder", "quant_conv"} <= set(vparams)  # the encoder travels too
    assert "encoder.down_blocks.0.downsamplers.0.conv.weight" in vae.state_dict()
    back, _, _ = conv.convert_sdxl_vae(_numpy_sd(vae))
    _assert_same_tree(back, vparams)


def test_state_dict_rejects_a_tree_of_another_shape():
    params = jax_params(ref_vit.VisionTransformerWithAttnPool(ref_vit.ViTConfig.tiny(width=96)),
                        jnp.zeros((1, 3, 56, 56)))
    vit = VisionTransformerWithAttnPool(ViTConfig.tiny(dtype=torch.float32))
    with pytest.raises(ValueError, match="shape"):
        W.vit_state_dict(vit, params)


def test_init_random_is_seeded_and_uses_flax_scales():
    cfg = port_agent.AgentConfig.tiny(llm=LlamaConfig.tiny(dtype=torch.float32, lora_rank=4))
    a = W.init_random_(port_agent.ContinuousLVLM(cfg), seed=5)
    b = W.init_random_(port_agent.ContinuousLVLM(cfg), seed=5)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    layer = a.llm.model.layers[0]
    assert torch.all(layer.self_attn.q_proj.lora_B.weight == 0)
    assert torch.all(layer.input_layernorm.weight == 1)
    w = a.llm.model.layers[0].mlp.down_proj.weight  # lecun normal, fan_in 352
    assert abs(float(w.detach().std()) * math.sqrt(352) - 1.0) < 0.05
    c = W.init_random_(port_agent.ContinuousLVLM(cfg), seed=6)
    assert not torch.equal(c.llm.lm_head.weight, a.llm.lm_head.weight)


def test_port_imports_no_jax_flax_yaml_or_pil():
    names = [m.name for m in pkgutil.walk_packages(seed_story_torch.__path__, "seed_story_torch.")]
    assert {f"seed_story_torch.{m}" for m in (
        "inference.common", "inference.gen_george", "inference.vis_george_sink",
        "pipelines.serving", "pipelines.story_generation", "pipelines.ipa_pipeline",
        "models.discrete", "models.ipa_adapters")} <= set(names)
    assert {f"seed_story_torch.train.{m}" for m in (
        "trainer", "stage2", "stage3", "checkpoint", "metrics", "runner", "scheduler",
        "train_clm_sft", "train_sdxl_img2img_llm", "train")} <= set(names)
    assert {f"seed_story_torch.data.{m}" for m in (
        "tokenizer", "story_telling", "datapipes", "builders", "transforms")} <= set(names)
    assert {f"seed_story_torch.benchmarks.{m}" for m in (
        "common", "probe_kernels", "probe_attn_variants", "probe_attn_overhead",
        "probe_attn_dma")} <= set(names)
    assert {f"seed_story_torch.tools.{m}" for m in (
        "convert_torch_weights", "reload_qwen_vit", "storystream", "multicard_check")} <= set(names)
    # the port keeps its own copies of the JAX package's framework-free modules
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'flax', 'yaml', 'PIL', 'seed_story_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
