"""Port parity of the int8 UNet (``SDXLUNetConfig.quantize``,
``quantize_unet_``), in f32 on the CPU on the tiny adapter, against the JAX
package on the same weights:

- ``quantize_unet_`` on carried float weights gives the JAX
  ``quantize_unet_params`` tree bitwise (int8 bytes and scales), on the
  modules of ``QUANTIZED_MODULES`` and no others, and a ``quantize=True``
  adapter filled from that JAX tree holds the same bytes;
- the port's int8 UNet against the JAX ``quantize=True`` UNet on the same
  int8 tree: 1e-5 of max |out|;
- the port's int8 UNet against its float UNet within the JAX package's own
  bound (``tests/test_sdxl_parity.py::test_unet_int8_close_to_float``: rel
  max < 0.02, correlation > 0.999);
- the int8 convolution and linear layers keep the JAX rounding order in
  bf16 (product rounded, times the rounded scale, then the bias).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from seed_story_torch import weights as W
from seed_story_torch.models.sdxl.adapter import SDXLAdapter, SDXLAdapterConfig, quantize_adapter_
from seed_story_torch.models.sdxl.unet import (QUANTIZED_MODULES, SDXLUNetConfig,
                                               UNet2DConditionModel, conv_nhwc,
                                               flax_module_name, quantize_unet_,
                                               quantized_modules)
from seed_story_torch.ops.dense import linear
from seed_story_tpu.models.sdxl import adapter as ref_adapter
from seed_story_tpu.models.sdxl import unet as ref_unet
from test_torch_weights import adapter_init_args, jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LAT = 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _int8_cfg(cfg):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, quantize=True))


@pytest.fixture(scope="module")
def trees():
    """The JAX tiny adapter's float tree and its int8 form (the UNet subtree
    through ``quantize_unet_params``)."""
    jadapter = ref_adapter.SDXLAdapter(ref_adapter.SDXLAdapterConfig.tiny())
    params = jax_params(jadapter, seed=12, **adapter_init_args(LAT))
    qparams = dict(params)
    qparams["unet"] = jax.tree_util.tree_map(
        np.asarray, ref_unet.quantize_unet_params(params["unet"]))
    return params, qparams


def _flat(tree):
    return traverse_util.flatten_dict(nn.meta.unbox(tree), sep="/")


def _float_adapter(params):
    adapter = SDXLAdapter(SDXLAdapterConfig.tiny()).eval()
    adapter.load_state_dict(W.adapter_state_dict(adapter, params))
    return adapter


def test_quantize_unet_matches_jax_bitwise(trees):
    params, qparams = trees
    adapter = quantize_adapter_(_float_adapter(params))
    assert adapter.cfg.unet.quantize and adapter.unet.cfg.quantize
    flat = _flat(qparams)
    paths = W.adapter_flax_paths(adapter)
    got = adapter.state_dict()
    assert sorted(p for p, _ in paths.values()) == sorted(flat)  # every leaf once
    for key, (path, transform) in paths.items():
        want = transform(flat[path])
        assert got[key].dtype == (torch.int8 if want.dtype == np.int8 else torch.float32), key
        np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)
    # the int8 modules are the JAX tree's: one kernel_scale each, no others
    jax_int8 = {p.rpartition("/")[0] for p in flat if p.endswith("kernel_scale")}
    port_int8 = {paths[f"unet.{name}.weight"][0].rpartition("/")[0]
                 for name, _ in quantized_modules(adapter.unet)}
    assert port_int8 == jax_int8 and len(jax_int8) > 10
    assert {flax_module_name(n) for n, _ in quantized_modules(adapter.unet)} == QUANTIZED_MODULES
    assert adapter.unet.conv_in.weight.dtype == torch.float32  # the edges stay float
    assert adapter.unet.down_blocks[0].resnets[0].time_emb_proj.weight.dtype == torch.float32
    # a quantize=True adapter filled from the JAX int8 tree holds the same bytes
    qadapter = SDXLAdapter(_int8_cfg(SDXLAdapterConfig.tiny()))
    qadapter.load_state_dict(W.adapter_state_dict(qadapter, qparams))
    for key, value in qadapter.state_dict().items():
        assert torch.equal(value, got[key]), key


def _denoise_inputs(seed=1):
    rng = np.random.RandomState(seed)
    lat = rng.randn(2, LAT, LAT, 4).astype(np.float32)
    t = np.array([901.0, 41.0], np.float32)
    prompt = rng.randn(2, 8, 96).astype(np.float32)
    pooled = rng.randn(2, 64).astype(np.float32)
    time_ids = np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (2, 1))
    return lat, t, prompt, pooled, time_ids


def test_int8_unet_matches_the_jax_quantized_unet(trees):
    _, qparams = trees
    jadapter = ref_adapter.SDXLAdapter(_int8_cfg(ref_adapter.SDXLAdapterConfig.tiny()))
    inputs = _denoise_inputs()
    want = np.asarray(jax.jit(lambda p, *a: jadapter.apply(
        {"params": p}, *a, method=jadapter.denoise))(qparams, *map(jnp.asarray, inputs)))
    adapter = SDXLAdapter(_int8_cfg(SDXLAdapterConfig.tiny())).eval()
    adapter.load_state_dict(W.adapter_state_dict(adapter, qparams))
    with torch.no_grad():
        got = adapter.denoise(*map(torch.from_numpy, inputs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_int8_unet_close_to_float_within_the_jax_bound():
    """The JAX bound's own setting: the tiny UNet's flax init at
    PRNGKey(42) and the JAX test's inputs, carried to the port, whose float
    and int8 UNets must differ by rel max < 0.02 and correlate above 0.999
    (the bound holds for these weights; on ``jax_params``' randomized biases
    and norm scales both packages read 0.031 alike)."""
    cfg = ref_unet.SDXLUNetConfig.tiny()
    model = ref_unet.UNet2DConditionModel(cfg)
    sample = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 8, 8, 4)))
    ctx = np.array(jax.random.normal(jax.random.PRNGKey(2), (1, 5, cfg.cross_attention_dim)))
    time_ids = np.asarray([[1024., 1024., 0., 0., 1024., 1024.]], np.float32)
    pooled = np.array(jax.random.normal(jax.random.PRNGKey(3), (1, cfg.pooled_projection_dim)))
    params = jax.tree_util.tree_map(np.array, nn.meta.unbox(model.init(
        jax.random.PRNGKey(42), sample, jnp.asarray(57), ctx, time_ids, pooled)["params"]))
    unet = UNet2DConditionModel(SDXLUNetConfig.tiny()).eval()
    unet.load_state_dict(W.adapter_state_dict(unet, params))
    inputs = (torch.from_numpy(sample), torch.tensor(57), torch.from_numpy(ctx))
    kw = dict(time_ids=torch.from_numpy(time_ids), text_embeds=torch.from_numpy(pooled))
    with torch.no_grad():
        ref = unet(*inputs, **kw).double().numpy()
        quantize_unet_(unet)
        got = unet(*inputs, **kw).double().numpy()
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert 0 < rel < 0.02, rel
    assert np.corrcoef(ref.ravel(), got.ravel())[0, 1] > 0.999


def test_int8_layers_keep_the_jax_rounding_order_in_bf16():
    """bf16 compute: the conv / product rounded to bf16, times the bf16
    scale (rounded), plus the bf16 bias (rounded), as the JAX ``QConv`` /
    ``QDense`` with dtype bf16; the layers' float weights are gone."""
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    conv = torch.nn.Conv2d(16, 8, 3, padding=1)
    lin = torch.nn.Linear(32, 24)
    for m in (conv, lin):
        m.weight.data.normal_(generator=gen)
        m.bias.data.normal_(generator=gen)
    unet = UNet2DConditionModel(SDXLUNetConfig.tiny())
    x = torch.randn(2, 5, 5, 16, generator=gen).to(bf16)
    h = torch.randn(3, 32, generator=gen).to(bf16)
    # the quantizer is quantize_unet_'s; put the two layers where it looks
    unet.down_blocks[0].resnets[0].conv1 = conv
    unet.mid_block.attentions[0].transformer_blocks[0].attn1.to_out[0] = lin
    quantize_unet_(unet)
    assert conv.weight.dtype == lin.weight.dtype == torch.int8
    want = (torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(bf16),
                                       padding=1).permute(0, 2, 3, 1)
            * conv.weight_scale.to(bf16)) + conv.bias.to(bf16)
    assert torch.equal(conv_nhwc(conv, x, bf16), want)
    want = (h.float() @ lin.weight.float().T).to(bf16) * lin.weight_scale.to(bf16)
    assert torch.equal(linear(lin, h, bf16), want + lin.bias.to(bf16))

