"""Port parity: ``seed_story_torch.models.llama`` against the JAX LLaMA on
the same weights (carried by ``seed_story_torch.weights``), in f32 on the
CPU: prefill logits, and cached decode (a >8-token prefill through ``mha``,
single tokens and a 3-token block through ``decode_attention``) against the
JAX full forward. Tolerance 1e-4 max abs on the logits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_story_torch import weights as W
from seed_story_torch.models import llama as port
from seed_story_torch.ops.rope import rope_frequencies
from seed_story_tpu.models import llama as ref
from seed_story_tpu.ops.rope import rope_frequencies as ref_rope_frequencies
from test_torch_weights import jax_params

# Matmuls in full f32 on every backend, so the tolerances below hold.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-4
VARIANTS = [
    dict(),
    dict(lora_rank=4, num_key_value_heads=2, rope_scaling_type="dynamic", rope_scaling_factor=2.0),
    dict(lora_rank=4, rope_scaling_type="linear", rope_scaling_factor=2.0),
]


def _models(kw, seed=0):
    jmodel = ref.LlamaForCausalLM(ref.LlamaConfig.tiny(dtype=jnp.float32, **kw))
    params = jax_params(jmodel, jnp.ones((1, 8), jnp.int32), seed=seed)
    tmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(dtype=torch.float32, **kw))
    tmodel.load_state_dict(W.agent_state_dict(tmodel, params))
    return jmodel, params, tmodel.eval()


@pytest.mark.parametrize("kw", VARIANTS)
def test_prefill_logits_match_jax(kw):
    jmodel, params, tmodel = _models(kw)
    ids = np.random.RandomState(1).randint(100, 32000, size=(2, 12))
    want = jmodel.apply({"params": params}, jnp.asarray(ids))["logits"]
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("kw", VARIANTS)
def test_cache_decode_matches_jax_full_forward(kw):
    jmodel, params, tmodel = _models(kw, seed=3)
    ids = np.random.RandomState(2).randint(100, 32000, size=(2, 16))
    full = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids))["logits"])
    cache = port.KVCache.create(tmodel.cfg, batch=2, capacity=32, dtype=torch.float32)
    t = torch.from_numpy(ids)
    with torch.no_grad():
        for lo, hi in ((0, 10), (10, 11), (11, 12), (12, 13), (13, 16)):
            got = tmodel(t[:, lo:hi], cache=cache)["logits"]
            np.testing.assert_allclose(got.numpy(), full[:, lo:hi], rtol=0, atol=TOL)
    assert cache.length == [16, 16]


def test_logits_indices_and_vocab_mask():
    _, _, tmodel = _models({})
    ids = torch.from_numpy(np.random.RandomState(4).randint(100, 32000, size=(2, 9)))
    with torch.no_grad():
        full = tmodel(ids)["logits"]
        last = tmodel(ids, logits_indices=torch.tensor([8, 3]))["logits"]
    torch.testing.assert_close(last[:, 0], full[[0, 1], [8, 3]], rtol=0, atol=1e-5)
    assert torch.all(full[..., tmodel.cfg.vocab_size:] == -1e9)


@pytest.mark.parametrize("scaling", [None, "linear", "dynamic"])
def test_rope_frequencies_match_jax(scaling):
    pos = np.arange(0, 700, 7, dtype=np.int32).reshape(2, 50)
    kw = dict(base=10000.0, scaling_type=scaling, scaling_factor=2.0,
              max_position_embeddings=512)
    cos, sin = rope_frequencies(64, torch.from_numpy(pos), seq_len=700.0, **kw)
    jcos, jsin = ref_rope_frequencies(64, jnp.asarray(pos), seq_len=700, **kw)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0, atol=TOL)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0, atol=TOL)
