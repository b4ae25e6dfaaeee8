"""Port parity of the int8 surface, in f32 on the CPU, against the JAX
package on the same inputs: ``quantize_kv_rows`` and ``quantize_llama_``
bitwise, the JAX int8 parameter tree through ``agent_state_dict`` bitwise,
the int8 ``LoRADense`` within 1e-5, ``decode_attention`` with int8 scales
within 1e-5 (S in {1, 5}, GQA), its gradient to x against ``jax.vjp``,
and an int8-weight, int8-KV model's
prefill and decode logits within 1e-3 of max |logit| with identical greedy
tokens. Also: the kernel routes refuse CPU tensors, and the plain int8
product keeps the JAX rounding order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_story_torch import weights as W
from seed_story_torch.models import llama as port
from seed_story_torch.ops.attention import decode_attention
from seed_story_torch.ops.int8_linear import int8_linear
from seed_story_tpu.models import llama as ref
from seed_story_tpu.ops.attention import decode_attention as ref_decode_attention
from test_torch_weights import jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models run thousands of small ops: one intra-op thread keeps
    them from oversubscribing the cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

VARIANTS = [dict(lora_rank=4), dict(lora_rank=4, num_key_value_heads=2)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def test_quantize_kv_rows_bitwise_equal_to_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 7, 64) * rng.choice([1e-3, 1.0, 40.0], size=(2, 3, 7, 1)))
    x = x.astype(np.float32)
    x[0, 1, 2] = 0.0  # an all-zero row: the floored divisor
    x[1, 0, 0, :4] = [127.5, -127.5, 0.5, -0.5]  # ties round half to even
    q, s = port.quantize_kv_rows(torch.from_numpy(x))
    jq, js = ref.quantize_kv_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("kw", VARIANTS)
def test_quantize_llama_and_int8_state_dict_bitwise_equal_to_jax(kw):
    """In-place ``quantize_llama_`` of the float model, and the int8 JAX tree
    loaded into a ``quantize_base`` model, give the JAX tree's bytes; LoRA,
    norms, embeddings and lm_head stay float."""
    jmodel = ref.LlamaForCausalLM(ref.LlamaConfig.tiny(dtype=jnp.float32, **kw))
    params = jax_params(jmodel, jnp.ones((1, 8), jnp.int32), seed=1)
    qparams = ref.quantize_llama_params(params)

    tmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(dtype=torch.float32, **kw))
    tmodel.load_state_dict(W.agent_state_dict(tmodel, params))
    port.quantize_llama_(tmodel)
    got = tmodel.state_dict()
    flat = _flat(qparams)
    paths = W.agent_flax_paths(tmodel)
    assert sorted(p for p, _ in paths.values()) == sorted(flat)  # every leaf once
    n_int8 = 0
    for key, (path, transform) in paths.items():
        want = transform(flat[path])
        assert got[key].dtype == (torch.int8 if want.dtype == np.int8 else torch.float32), key
        np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)
        n_int8 += want.dtype == np.int8
    assert n_int8 == 7 * tmodel.cfg.num_hidden_layers
    assert tmodel.lm_head.weight.dtype == torch.float32

    qmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(dtype=torch.float32,
                                                         quantize_base=True, **kw))
    sd = W.agent_state_dict(qmodel, qparams)
    qmodel.load_state_dict(sd)
    for key, value in qmodel.state_dict().items():
        assert torch.equal(value, got[key]), key


@pytest.mark.parametrize("bias,rank", [(False, 0), (True, 4)])
def test_int8_lora_dense_matches_jax(bias, rank):
    jdense = ref.LoRADense(features=48, use_bias=bias, lora_rank=rank, quantize=True,
                           dtype=jnp.float32)
    x = np.random.RandomState(2).randn(2, 5, 64).astype(np.float32)
    rng = np.random.RandomState(3)
    shapes = jax.eval_shape(lambda: jdense.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = jax.tree_util.tree_map(lambda s: (0.1 * rng.randn(*s.shape)).astype(np.float32),
                                    ref.nn.meta.unbox(shapes["params"]))
    params["kernel"] = rng.randint(-127, 128, size=(64, 48)).astype(np.int8)
    params["kernel_scale"] = (rng.rand(48) / (127 * 8)).astype(np.float32)  # outputs ~1
    want = jdense.apply({"params": params}, jnp.asarray(x))

    dense = port.LoRADense(64, 48, bias=bias, lora_rank=rank, quantize=True,
                           dtype=torch.float32)
    sd = {"weight": torch.from_numpy(params["kernel"].T.copy()),
          "weight_scale": torch.from_numpy(params["kernel_scale"])}
    if bias:
        sd["bias"] = torch.from_numpy(params["bias"])
    if rank:
        sd["lora_A.weight"] = torch.from_numpy(params["lora_a"].T.copy())
        sd["lora_B.weight"] = torch.from_numpy(params["lora_b"].T.copy())
    dense.load_state_dict(sd)
    with torch.no_grad():
        got = dense(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype,bias,rank", [("float32", False, 0), ("float32", True, 4),
                                             ("bfloat16", False, 0)])
def test_int8_lora_dense_gradient_to_x_matches_jax_vjp(dtype, bias, rank):
    """The gradient to x through an int8 ``LoRADense`` (the quantize_base
    training backward) against ``jax.vjp`` of the JAX ``LoRADense(quantize=True)``
    on the same int8 kernel: in f32 within 1e-5 of max |dx|; in bf16 (the
    base product alone: g times the bf16 scale rounded, then the product
    with W rounded) within one bf16 spacing of each element. The int8 weight
    and its scale take no gradient."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jdense = ref.LoRADense(features=48, use_bias=bias, lora_rank=rank, quantize=True, dtype=jdt)
    rng = np.random.RandomState(21)
    x = torch.from_numpy(rng.randn(2, 5, 64).astype(np.float32)).to(tdt)
    g = torch.from_numpy(rng.randn(2, 5, 48).astype(np.float32)).to(tdt)
    shapes = jax.eval_shape(lambda: jdense.init(jax.random.PRNGKey(0), jnp.zeros((2, 5, 64))))
    params = jax.tree_util.tree_map(lambda s: (0.1 * rng.randn(*s.shape)).astype(np.float32),
                                    ref.nn.meta.unbox(shapes["params"]))
    params["kernel"] = rng.randint(-127, 128, size=(64, 48)).astype(np.int8)
    params["kernel_scale"] = (rng.rand(48) / (127 * 8)).astype(np.float32)

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(jdt)

    _, vjp = jax.vjp(lambda xx: jdense.apply({"params": params}, xx), jx(x))
    want = np.asarray(vjp(jx(g))[0].astype(jnp.float32))

    dense = port.LoRADense(64, 48, bias=bias, lora_rank=rank, quantize=True, dtype=tdt)
    sd = {"weight": torch.from_numpy(params["kernel"].T.copy()),
          "weight_scale": torch.from_numpy(params["kernel_scale"])}
    if bias:
        sd["bias"] = torch.from_numpy(params["bias"])
    if rank:
        sd["lora_A.weight"] = torch.from_numpy(params["lora_a"].T.copy())
        sd["lora_B.weight"] = torch.from_numpy(params["lora_b"].T.copy())
    dense.load_state_dict(sd)
    xt = x.clone().requires_grad_()
    dense(xt).backward(g)
    assert dense.weight.grad is None and dense.weight_scale.grad is None
    got = xt.grad.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    else:
        spacing = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7
        assert np.all(np.abs(got - want) <= spacing)


def test_int8_linear_plain_rounding_order_and_kernel_route():
    """bf16 inputs: the plain product rounds x W^T to bf16, then the product
    with the bf16 scale (the JAX order); the kernel route takes CUDA tensors
    only."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 64).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.randint(-127, 128, size=(32, 64)).astype(np.int8))
    scale = torch.from_numpy((rng.rand(32) * 0.02).astype(np.float32))
    want = (x.float() @ w.float().T).to(torch.bfloat16) * scale.to(torch.bfloat16)
    got = int8_linear(x, w, scale)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        int8_linear(x, w, scale, implementation="kernel")


@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_decode_attention_with_scales_matches_jax(sq, hq, hkv):
    rng = np.random.RandomState(5 + sq + hkv)
    b, c, d = 3, 40, 64
    q = rng.randn(b, hq, sq, d).astype(np.float32)
    k, ks = port.quantize_kv_rows(torch.from_numpy(rng.randn(b, hkv, c, d).astype(np.float32)))
    v, vs = port.quantize_kv_rows(torch.from_numpy(rng.randn(b, hkv, c, d).astype(np.float32)))
    q_start = np.asarray([0, 13, c - sq], np.int32)
    kv_len = q_start + sq
    kv_len[1] -= 2  # a row with fewer valid new tokens than queries
    want = ref_decode_attention(
        jnp.asarray(q), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        kv_len=jnp.asarray(kv_len), q_start=jnp.asarray(q_start),
        k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
    got = decode_attention(torch.from_numpy(q), k, v, kv_len=torch.from_numpy(kv_len),
                           q_start=torch.from_numpy(q_start), k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(torch.from_numpy(q), k, v, kv_len=torch.from_numpy(kv_len),
                         q_start=torch.from_numpy(q_start), k_scale=ks, v_scale=vs,
                         implementation="kernel")


@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_in_bf16_keeps_f32_scores_like_jax(int8, sq):
    """bf16 q over a bf16 or int8 cache (GQA 2), both in bf16: the scores are
    f32 products in both (the JAX ``preferred_element_type``), so the outputs
    differ only where an f32 sum in another order flips a bf16 rounding. The
    limit: at most one bf16 spacing per element, on at most 1% of them.
    Scores rounded to bf16 before ``.float()`` change over half of the
    outputs, by up to 50 spacings."""
    rng = np.random.RandomState(11 + sq + int8)
    b, hq, hkv, c, d = 2, 8, 4, 96, 64
    q = torch.from_numpy(rng.randn(b, hq, sq, d).astype(np.float32)).to(torch.bfloat16)
    kf, vf = (torch.from_numpy(rng.randn(b, hkv, c, d).astype(np.float32)) for _ in range(2))
    if int8:
        (k, ks), (v, vs) = port.quantize_kv_rows(kf), port.quantize_kv_rows(vf)
    else:
        k, v, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    q_start = np.asarray([c - sq - 7, c - sq], np.int32)
    kv_len = q_start + sq

    def jx(t):
        if t is None or t.dtype != torch.bfloat16:
            return None if t is None else jnp.asarray(t.numpy())
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    want = ref_decode_attention(jx(q), jx(k), jx(v), kv_len=jnp.asarray(kv_len),
                                q_start=jnp.asarray(q_start), k_scale=jx(ks), v_scale=jx(vs))
    want = np.asarray(want.astype(jnp.float32))
    got = decode_attention(q, k, v, kv_len=torch.from_numpy(kv_len),
                           q_start=torch.from_numpy(q_start), k_scale=ks, v_scale=vs)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    spacing = np.maximum(np.abs(want), 2.0 ** -126) * 2.0 ** -7
    assert np.all(np.abs(got - want) <= spacing)
    assert np.mean(got != want) <= 0.01


def test_int8_weight_and_kv_prefill_decode_match_jax():
    """quantize_base + quantize_kv: a 10-token prefill (dequantized cache
    through ``mha``), two single tokens and a 3-token block (``decode_attention``
    with scales), against the JAX model's cached calls on the same int8 tree
    (GQA and LoRA on)."""
    kw = VARIANTS[1]
    jcfg = ref.LlamaConfig.tiny(dtype=jnp.float32, quantize_base=True, quantize_kv=True, **kw)
    jmodel = ref.LlamaForCausalLM(jcfg)
    fmodel = ref.LlamaForCausalLM(ref.LlamaConfig.tiny(dtype=jnp.float32, **kw))
    qparams = ref.quantize_llama_params(
        jax_params(fmodel, jnp.ones((1, 8), jnp.int32), seed=6))
    tmodel = port.LlamaForCausalLM(port.LlamaConfig.tiny(
        dtype=torch.float32, quantize_base=True, quantize_kv=True, **kw))
    tmodel.load_state_dict(W.agent_state_dict(tmodel, qparams))
    tmodel.eval()

    ids = np.random.RandomState(7).randint(100, 32000, size=(2, 15))
    jcache = ref.KVCache.create(jcfg, 2, 32, dtype=jnp.float32)
    cache = port.KVCache.create(tmodel.cfg, 2, 32, dtype=torch.float32)
    assert cache.quantized and cache.k[0].dtype == torch.int8
    japply = jax.jit(lambda ids, cache: jmodel.apply({"params": qparams}, ids, cache=cache))
    with torch.no_grad():
        for lo, hi in ((0, 10), (10, 11), (11, 12), (12, 15)):
            out = japply(jnp.asarray(ids[:, lo:hi]), jcache)
            jcache = out["cache"]
            want = np.asarray(out["logits"])[..., :jcfg.vocab_size]
            got = tmodel(torch.from_numpy(ids[:, lo:hi]), cache=cache)["logits"]
            got = got.numpy()[..., :jcfg.vocab_size]
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert cache.length == [15, 15]
    for layer in range(jcfg.num_hidden_layers):  # the quantized cache rows agree
        jk = np.asarray(jcache.k[layer])[:, :, :15]
        diff = cache.k[layer][:, :, :15].numpy().astype(np.int32) - jk.astype(np.int32)
        assert np.abs(diff).max() <= 1  # a rounding flip from 1e-7 differences at most
        np.testing.assert_allclose(cache.k_scale[layer][:, :, :15].numpy(),
                                   np.asarray(jcache.k_scale[layer])[:, :, :15],
                                   rtol=1e-5, atol=0)


def test_init_random_of_an_int8_model_is_seeded():
    cfg = port.LlamaConfig.tiny(dtype=torch.float32, quantize_base=True, lora_rank=4)
    a = W.init_random_(port.LlamaForCausalLM(cfg), seed=3)
    b = W.init_random_(port.LlamaForCausalLM(cfg), seed=3)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    q = a.model.layers[0].self_attn.q_proj
    assert q.weight.dtype == torch.int8 and int(q.weight.abs().max()) == 127
