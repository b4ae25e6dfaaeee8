"""K-EXAONE's block in the port (``models/llama.py`` with ``models/moe.py``)
against the plain float32 reference of ``tests/reference_kexaone.py``, at a
tiny size: hidden 128, 4 query and 2 KV heads of 32, layer 0 dense and one
LLLG period of windowed (8) and global layers, 8 experts of which a device
holds 4, top-2, one shared expert. And the LLaMA path left as it was.

CPU tests run the plain versions. The tests marked ``gpu`` hold the CUDA
kernels (the grouped int8 expert kernel, kernel B and the flash forward
with a window) to their plain versions and check that a verify pass makes
no host sync; they skip without a card and import neither JAX nor the JAX
package: ``python -m pytest --noconftest -m gpu tests/test_torch_kexaone.py``.

Tolerances: 1e-4 max abs on f32 logits (the f32 port against the f32
reference, sums in another order), 1e-5 on the f32 attention and expert
sums; on the card the twins' tolerances of ``test_torch_decode_gpu.py``.
"""

from __future__ import annotations

import math

import pytest
import torch

import reference_kexaone as ref
from seed_story_torch.models.llama import KVCache, LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM
from seed_story_torch.models.moe import MoE, MoEConfig
from seed_story_torch.ops.attention import decode_attention, mha
from seed_story_torch.ops.int8_linear import grouped_int8_linear, int8_linear_reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

WINDOW = 8
TOL = 1e-4


def tiny(held=(0, 4), **kw) -> LlamaConfig:
    base = dict(vocab_size=300, hidden_size=128, intermediate_size=96, num_hidden_layers=5,
                num_attention_heads=4, num_key_value_heads=2, head_size=32,
                max_position_embeddings=256, rope_theta=1e6, lora_rank=4,
                sliding_windows=(WINDOW, WINDOW, WINDOW, 0, WINDOW), nope_global=True,
                qk_norm=True, post_norms=True, first_k_dense_replace=1,
                moe=MoEConfig(num_experts=8, experts_per_token=2, intermediate_size=64,
                              num_shared_experts=1, routed_scaling_factor=2.5, held=held),
                dtype=torch.float32, param_dtype=torch.float32)
    base.update(kw)
    return LlamaConfig(**base)


def fill_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded weights: norms near 1, biases near 0, matrices 1 / sqrt(fan in)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            if p.dtype == torch.int8:
                continue
            if p.dim() == 1:
                base = 0.0 if name.endswith("bias") else 1.0
                p.copy_(base + 0.1 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[-1]))
    return module


def ref_config(cfg: LlamaConfig) -> dict:
    return dict(hidden_size=cfg.hidden_size, num_attention_heads=cfg.num_attention_heads,
                num_key_value_heads=cfg.kv_heads, head_dim=cfg.head_dim,
                num_hidden_layers=cfg.num_hidden_layers, sliding_windows=cfg.sliding_windows,
                rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_norm_eps,
                first_k_dense_replace=cfg.first_k_dense_replace,
                top_k=cfg.moe.experts_per_token,
                routed_scaling_factor=cfg.moe.routed_scaling_factor,
                lora_scaling=cfg.lora_alpha / cfg.lora_rank, vocab_size=cfg.vocab_size)


def dequantized_state(model: torch.nn.Module) -> dict:
    """The state dict with each int8 weight as weight * scale (f32)."""
    sd = dict(model.state_dict())
    for name in [n for n, t in sd.items() if t.dtype == torch.int8]:
        scale_name = name[:-len(".weight")] + ".weight_scale" if name.endswith(".weight") else (
            name + "_scale")
        sd[name] = sd[name].float() * sd.pop(scale_name)[..., None]
    return sd


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_then_verify_blocks_match_the_reference(quantized):
    """Two rows prefilled right-padded (13 and 10 tokens), then three verify
    blocks of K + 1 = 5 through the float cache, crossing the window's edge:
    every position's logits against the reference's full forward."""
    torch.manual_seed(0)
    cfg = tiny()
    model = fill_(LlamaForCausalLM(cfg), 1).eval()
    if quantized:
        from seed_story_torch.models.llama import quantize_llama_
        quantize_llama_(model)
    lens = [13, 10]
    ids = torch.randint(0, cfg.vocab_size, (2, 13 + 15))
    cache = KVCache.create(cfg, batch=2, capacity=64, dtype=torch.float32)
    got = [[], []]
    with torch.no_grad():
        out = model(ids[:, :13], cache=cache, seq_lengths=lens)
        for r in range(2):
            got[r].append(out["logits"][r, :lens[r]])
        for blk in range(3):
            block = torch.stack([ids[r, lens[r] + 5 * blk:lens[r] + 5 * blk + 5]
                                 for r in range(2)])
            out = model(block, cache=cache)
            for r in range(2):
                got[r].append(out["logits"][r])
    assert cache.length == [28, 25]
    sd = dequantized_state(model)
    for r in range(2):
        n = lens[r] + 15
        x = model.model.embed_tokens.weight[ids[r, :n]]
        want, _ = ref.forward(sd, ref_config(cfg), x, held=cfg.moe.held_range)
        torch.testing.assert_close(torch.cat(got[r]), want, rtol=0, atol=TOL)


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """Two devices' shares (experts 0-3 and 4-7) of one expert layer: their
    routed parts, with the shared expert counted once, equal the uncut
    reference layer."""
    full = fill_(MoE(tiny(held=(0, 8))), 2)
    shares = []
    for first in (0, 4):
        share = MoE(tiny(held=(first, 4)))
        state = dict(full.state_dict())
        for name in ("experts.gate_up_proj", "experts.down_proj"):
            state[name] = state[name][first:first + 4]
        share.load_state_dict(state)
        shares.append(share)
    x = torch.randn(2, 6, 128, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        h = x.reshape(-1, 128)
        shared = full.shared_experts(h)
        parts = sum(s(x).reshape(-1, 128) for s in shares) - shared
        c = ref_config(full.cfg)
        sd = {"mlp." + k: v for k, v in full.state_dict().items()}
        want = ref.moe(sd, "mlp.", h, c, c["lora_scaling"], held=(0, 8))
    torch.testing.assert_close(parts, want, rtol=1e-5, atol=1e-5)


def _masked(q, k, v, lower, upper):
    """Attention of (B, H, S, d) q over the keys lower <= j < upper (B, S)."""
    group = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    j = torch.arange(k.shape[2])
    visible = (j >= lower[:, None, :, None]) & (j < upper[:, None, :, None])
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.softmax(s.masked_fill(~visible, float("-inf")), -1) @ v


def test_windowed_plain_attention_matches_a_masked_reference_at_the_edge():
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(2, 4, 5, 32, generator=gen)
    k, v = (torch.randn(2, 2, 24, 32, generator=gen) for _ in range(2))
    start = torch.tensor([6, 15], dtype=torch.int32)  # row 0 crosses the window's start
    end = start + 5
    pos = start[:, None] + torch.arange(5)[None]
    want = _masked(q, k, v, pos + 1 - WINDOW, pos + 1)
    got = decode_attention(q, k, v, kv_len=end, q_start=start, window=WINDOW)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    got = mha(q, k, v, causal=True, q_start=start, kv_len=end, window=WINDOW)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    one = decode_attention(q[:, :, :1], k, v, kv_len=end, window=WINDOW)  # the query at end - 1
    torch.testing.assert_close(one, _masked(q[:, :, :1], k, v, end[:, None] - WINDOW,
                                            end[:, None]), rtol=0, atol=1e-5)


def _dispatch(held, experts):
    layer = MoE(tiny(held=held))
    return layer.dispatch(experts)


def test_the_plain_grouped_product_equals_per_expert_int8_products():
    gen = torch.Generator().manual_seed(5)
    tokens, top_k, n, kk = 7, 2, 48, 64
    experts = torch.stack([torch.randperm(8, generator=gen)[:top_k] for _ in range(tokens)])
    order, offsets = _dispatch((2, 4), experts)
    x = torch.randn(tokens, kk, generator=gen)
    w = torch.randint(-127, 128, (4, n, kk), generator=gen, dtype=torch.int8)
    scale = torch.rand(4, n, generator=gen) / 127
    got = grouped_int8_linear(x, w, scale, order, offsets, top_k)
    assert got.shape == (tokens * top_k, n)
    listed = torch.zeros(tokens * top_k, dtype=torch.bool)
    for e in range(4):
        tok, slot = (experts == 2 + e).nonzero(as_tuple=True)  # the expert's pairs, in order
        want = int8_linear_reference(x[tok], w[e], scale[e])
        torch.testing.assert_close(got[tok * top_k + slot], want, rtol=0, atol=0)
        listed[tok * top_k + slot] = True
    assert not got[~listed].any()
    assert int(offsets[-1]) == int(((experts >= 2) & (experts < 6)).sum())


def test_a_llama_layer_has_no_new_submodule_and_its_pre_norm_block():
    cfg = LlamaConfig.tiny(dtype=torch.float32, num_key_value_heads=2)
    layer = fill_(LlamaDecoderLayer(cfg), 6).eval()
    names = {n.rsplit(".", 1)[0] for n, _ in layer.named_parameters()}
    assert names == {"input_layernorm", "post_attention_layernorm", "self_attn.q_proj",
                     "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
                     "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"}
    assert layer.self_attn.window == 0 and layer.self_attn.rope
    x = torch.randn(1, 6, cfg.hidden_size, generator=torch.Generator().manual_seed(7))
    from seed_story_torch.ops.rope import rope_frequencies
    cos, sin = rope_frequencies(cfg.head_dim, torch.arange(6)[None])
    kw = dict(layer_idx=0, cache=None, start=torch.zeros(1, dtype=torch.int32), kv_len=None)
    with torch.no_grad():
        got = layer(x, cos, sin, **kw)
        h = x + layer.self_attn(layer.input_layernorm(x), cos, sin, **kw)
        want = h + layer.mlp(layer.post_attention_layernorm(h))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.gpu
def test_grouped_kernel_matches_its_twin_and_a_row_alone():
    """The grouped kernel at K-EXAONE's widths (16 held experts, 2048 and
    6144) against its plain version, and one pair's output alone (one token)
    bit-equal to the same pair among 39 other tokens."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    e, top_k, tokens = 16, 8, 40
    for n, kk, in_div in ((4096, 6144, top_k), (6144, 2048, 1)):
        w = torch.randint(-127, 128, (e, n, kk), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand(e, n, generator=gen, device="cuda") / (127 * kk ** 0.5)
        experts = torch.stack([torch.randperm(128, generator=gen, device="cuda")[:top_k]
                               for _ in range(tokens)])
        experts[:, 0] = torch.arange(tokens, device="cuda") % e  # every token holds a pair
        order, offsets = _dispatch_cuda(e, experts)
        x = torch.randn(tokens * top_k // in_div, kk, generator=gen,
                        device="cuda").to(torch.bfloat16)
        got = grouped_int8_linear(x, w, scale, order, offsets, in_div)
        want = grouped_int8_linear(x, w, scale, order, offsets, in_div, implementation="plain")
        err = (got.float() - want.float()).abs()
        assert err.max() <= 1e-2 * want.float().abs().max()
        assert err.mean() <= 1e-3 * want.float().abs().mean()
        rows = slice(0, top_k // in_div)  # token 0's rows of x
        o1, f1 = _dispatch_cuda(e, experts[:1])
        alone = grouped_int8_linear(x[rows], w, scale, o1, f1, in_div)
        assert torch.equal(alone, got[:top_k])


def _dispatch_cuda(e, experts):
    layer = MoE(tiny(held=(0, e), moe=MoEConfig(num_experts=128, experts_per_token=8,
                                                held=(0, e)))).cuda()
    return layer.dispatch(experts)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True])
def test_windowed_kernel_b_and_flash_forward_match_their_twins(quantized):
    _card()
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, hq, hkv, c, d = 8, 64, 8, 1600, 128
    q = torch.randn(b, hq, 5, d, generator=gen, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(b, hkv, c, d, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    start = torch.randint(100, c - 5, (b,), generator=gen, device="cuda", dtype=torch.int32)
    start[0] = 126  # the window's start crosses a 16-key tile inside the block
    end = start + 5
    ks = vs = None
    if quantized:
        from seed_story_torch.models.llama import quantize_kv_rows
        (k, ks), (v, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    for window in (128, 0):
        got = decode_attention(q, k, v, kv_len=end, q_start=start, k_scale=ks, v_scale=vs,
                               window=window)
        want = decode_attention(q.float(), k.float() if not quantized else k,
                                v.float() if not quantized else v, kv_len=end, q_start=start,
                                k_scale=ks, v_scale=vs, window=window, implementation="plain")
        err = (got.float() - want.float()).abs()
        assert err.max() <= 2e-2 and err.mean() <= 2e-3, (window, err.max(), err.mean())
    if quantized:
        return
    sq = 300  # a prefill block whose rows' windows start in different tiles
    qp = torch.randn(2, hq, sq, d, generator=gen, device="cuda").to(torch.bfloat16)
    kp, vp = (torch.randn(2, hkv, 700, d, generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    qs = torch.tensor([0, 390], dtype=torch.int32, device="cuda")
    kl = qs + sq
    got = mha(qp, kp, vp, causal=True, q_start=qs, kv_len=kl, window=128)
    want = mha(qp.float(), kp.float(), vp.float(), causal=True, q_start=qs, kv_len=kl,
               window=128, implementation="plain")
    err = (got.float() - want.float()).abs()
    assert err.max() <= 2e-2 and err.mean() <= 2e-3


@pytest.mark.gpu
def test_a_verify_pass_makes_no_host_sync():
    """The layers of a K + 1 verify pass of a tiny int8 model with an int8
    cache, under ``torch.cuda.set_sync_debug_mode("error")``: the K/V writes,
    kernel B with and without a window, the router, the dispatch and the
    grouped kernel. (``step_plan``'s lengths come from host lists and are
    copied before, as the decode loop does.)"""
    _card()
    from seed_story_torch.models.llama import quantize_llama_, step_plan

    torch.manual_seed(10)
    cfg = tiny(hidden_size=256, head_size=128, intermediate_size=384, quantize_kv=True,
               dtype=torch.bfloat16, param_dtype=torch.bfloat16,
               moe=MoEConfig(num_experts=8, experts_per_token=2, intermediate_size=128,
                             held=(0, 4)))
    with torch.device("cuda"):
        model = LlamaForCausalLM(cfg)
    model = quantize_llama_(fill_(model, 11)).eval()
    cache = KVCache.create(cfg, batch=8, capacity=128, device="cuda")
    ids = torch.randint(0, cfg.vocab_size, (8, 40), device="cuda")
    with torch.no_grad():
        model(ids[:, :35], cache=cache)
        x = model.embed(ids[:, 35:])
        start, kv_len, cos, sin, _ = step_plan(cfg, x, cache, None, None)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i, layer in enumerate(model.model.layers):
                x = layer(x, cos, sin, layer_idx=i, cache=cache, start=start, kv_len=kv_len)
            logits = model._logits(model.model.norm(x))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(logits.float()).all()
