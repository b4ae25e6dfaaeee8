"""The port's whole slice on a tiny configuration, against the JAX
pipeline on the same weights, in f32 on the CPU: ``build_stack`` (ViT,
agent, SDXL adapter, VAE from the JAX parameter trees) ->
``StoryGenerationPipeline.run`` for 3 segments with window 2 (so the
oldest image is evicted once) and ``force_boi_at`` set. Greedy tokens and
texts must be identical; the regressed image features agree to 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from seed_story_torch.inference.common import build_stack
from seed_story_torch.models.agent import AgentConfig
from seed_story_torch.models.sdxl.adapter import SDXLAdapterConfig
from seed_story_torch.models.sdxl.vae import VAEConfig
from seed_story_torch.models.vit import ViTConfig
from seed_story_torch.pipelines import story_generation as port_story
from seed_story_tpu.data.tokenizer import TinyTokenizer
from seed_story_tpu.decode.generate import GenerateConfig, StoryGenerator
from seed_story_tpu.models import agent as ref_agent
from seed_story_tpu.models import vit as ref_vit
from seed_story_tpu.models.sdxl import adapter as ref_adapter
from seed_story_tpu.models.sdxl import vae as ref_vae
from seed_story_tpu.pipelines import story_generation as ref_story
from test_torch_weights import adapter_init_args, agent_init_args, jax_params

# Matmuls and convolutions in full f32 on every backend, so the tolerances hold.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

MAX_NEW = 32
FORCE_BOI_AT = MAX_NEW - 9 - 8  # as the bench: image block well inside max_new


def _recorded(generator):
    """Wraps ``generator.generate`` to keep every call's generated ids."""
    calls, generate = [], generator.generate

    def wrapped(*args, **kwargs):
        out = generate(*args, **kwargs)
        calls.append(np.asarray(out["generate_ids"]))
        return out

    generator.generate = wrapped
    return calls


def test_tiny_story_matches_jax_pipeline():
    jvit = ref_vit.VisionTransformerWithAttnPool(ref_vit.ViTConfig.tiny(dtype=jnp.float32,
                                                                        n_queries=9))
    jcfg = ref_agent.AgentConfig.tiny()
    jagent = ref_agent.ContinuousLVLM(jcfg)
    weights = {
        "vit": jax_params(jvit, jnp.zeros((1, 3, 56, 56)), seed=1),
        "agent": jax_params(jagent, seed=2, **agent_init_args(jcfg)),
        "adapter": jax_params(ref_adapter.SDXLAdapter(ref_adapter.SDXLAdapterConfig.tiny()),
                              seed=3, **adapter_init_args()),
        "vae": jax_params(ref_vae.AutoencoderKL(ref_vae.VAEConfig.tiny()),
                          jnp.zeros((1, 8, 8, 3)), seed=4),
    }
    story_cfg = dict(story_len=4, window_size=2, num_img_in_tokens=jcfg.num_img_in_tokens)
    pixels = np.random.RandomState(0).randn(1, 3, 56, 56).astype(np.float32)
    caption = "george the monkey went to the park"

    vit_apply = jax.jit(lambda px: jvit.apply({"params": weights["vit"]}, px))
    jgen = StoryGenerator(jagent, weights["agent"], GenerateConfig(
        max_new_tokens=MAX_NEW, num_img_gen_tokens=jcfg.num_img_out_tokens, eos_token_id=-1,
        cache_capacity=512, force_boi_at=FORCE_BOI_AT))
    want_ids = _recorded(jgen)
    want = list(ref_story.StoryGenerationPipeline(
        TinyTokenizer(), jgen, lambda px: np.asarray(vit_apply(jnp.asarray(px))), None,
        ref_story.StoryPipelineConfig(**story_cfg)).run(pixels, caption))

    stack = build_stack(
        ViTConfig.tiny(dtype=torch.float32, n_queries=9), AgentConfig.tiny(),
        SDXLAdapterConfig.tiny(), VAEConfig.tiny(), weights=weights, device="cpu",
        max_new_tokens=MAX_NEW, cache_capacity=512, num_inference_steps=2, image_size=16,
        force_boi_at=FORCE_BOI_AT, eos_token_id=-1)
    got_ids = _recorded(stack.generator)
    got = list(port_story.StoryGenerationPipeline(
        stack.tokenizer, stack.generator, stack.visual_encode, stack.detokenize,
        port_story.StoryPipelineConfig(**story_cfg)).run(pixels, caption))

    assert len(want) == len(got) == 3
    assert len(want_ids) == len(got_ids) == 3
    for w, g in zip(want_ids, got_ids):
        np.testing.assert_array_equal(g, w)
    for w, g in zip(want, got):
        assert (g.index, g.text, g.context_tokens) == (w.index, w.text, w.context_tokens)
        np.testing.assert_allclose(g.image_features.numpy(), w.image_features, rtol=0, atol=1e-3)
        assert g.image.shape == (16, 16, 3) and g.image.dtype == np.uint8
