"""``seed_story_torch.tools.convert_torch_weights`` against the JAX converter
(``seed_story_tpu/tools/convert_torch_weights.py``) on synthetic state dicts
in the released layouts, on the CPU at tiny widths.

For each family the port's state dict equals ``seed_story_torch.weights``'
state dict of the JAX converter's tree, bit for bit (the frozen sin-cos
``pos_embed`` buffers aside, which both converters drop), and its missing and
unexpected lists equal the JAX ones: a PEFT-wrapped HF ``LlamaForCausalLM``
(``peft.get_peft_model``: LoRA r=4 on the seven projections, the layernorms in
``modules_to_save``, trained copies unlike the ``original_module`` ones), in
PEFT's key order and reversed, with and without a shuffled
``added_tokens.json``; the agent bin through the CLI, float and ``--int8``
(bit-equal to ``quantize_llama_params`` carried across); a Qwen ViT; the
SDXL-layout UNet, VAE and de-tokenizer; the yuying remap (a torch layout on
both sides, so compared key for key) and the legacy IP-Adapter (its
``ip_layers`` equal to the transposes of the JAX kernels). A tiny agent
filled from the CLI's file gives the JAX model's logits within
``TOL``; an ``--int8`` file loads through ``load_checkpoint_`` as it was
written. Also: the CLI's refusals, the torchrun launch scripts' flags parsed by
their entries' own ``parse_args``, and ``chip_smoke.py``'s released-layout
writer against PEFT's own key names.
"""

import json
import os
import shlex

os.environ.setdefault("USE_TF", "0")  # transformers need not import TensorFlow here

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from seed_story_torch import weights as W  # noqa: E402
from seed_story_torch.data.tokenizer import (BOI_TOKEN_ID, LLAMA_VOCAB_SIZE,  # noqa: E402
                                             special_tokens)
from seed_story_torch.inference.common import fill_module, quantize_agent_  # noqa: E402
from seed_story_torch.models.agent import AgentConfig, ContinuousLVLM  # noqa: E402
from seed_story_torch.models.ipa_resampler import IPAResampler  # noqa: E402
from seed_story_torch.models.llama import LlamaConfig, LlamaForCausalLM  # noqa: E402
from seed_story_torch.models.sdxl.adapter import SDXLAdapter, SDXLAdapterConfig  # noqa: E402
from seed_story_torch.models.sdxl.vae import AutoencoderKL, VAEConfig  # noqa: E402
from seed_story_torch.models.vit import VisionTransformerWithAttnPool, ViTConfig  # noqa: E402
from seed_story_torch.tools import convert_torch_weights as port  # noqa: E402
from seed_story_torch.train.checkpoint import load_checkpoint_  # noqa: E402
from seed_story_tpu.models import llama as ref_llama  # noqa: E402
from seed_story_tpu.tools import convert_torch_weights as conv  # noqa: E402

peft = pytest.importorskip("peft")

TOL = 1e-4  # logits, max abs (tests/test_torch_llama.py)
LORA = 4
PROJECTIONS = ["q_proj", "v_proj", "k_proj", "o_proj", "gate_proj", "down_proj", "up_proj"]
NORMS = ["input_layernorm", "post_attention_layernorm", "norm"]  # llama2chat7b_lora.yaml
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _random_sd(module, seed):
    """``module``'s state dict names and shapes with seeded random values."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen) for k, v in module.state_dict().items()}


def _assert_same(got, want):
    """``got`` equals ``want`` bit for bit, ``want``'s pos_embed buffers aside."""
    want = {k: v for k, v in want.items() if not k.endswith("pos_embed")}
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        assert got[k].dtype == v.dtype, (k, got[k].dtype, v.dtype)
        assert torch.equal(got[k], v), k


def _shuffled_added_tokens(seed=0):
    """A released added_tokens.json whose 66 tokens sit in a seeded order."""
    order = np.random.RandomState(seed).permutation(len(special_tokens()))
    return {tok: LLAMA_VOCAB_SIZE + int(order[i]) for i, tok in enumerate(special_tokens())}


def _llm_cfg(**kw):
    return LlamaConfig.tiny(dtype=torch.float32, lora_rank=LORA, **kw)


def _peft_llama(cfg):
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM as HFLlama

    torch.manual_seed(0)
    hf = HFLlama(HFConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, num_key_value_heads=cfg.kv_heads,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        max_position_embeddings=cfg.max_position_embeddings, tie_word_embeddings=False,
        attn_implementation="eager")).eval()
    return peft.get_peft_model(hf, peft.LoraConfig(
        r=LORA, lora_alpha=32, target_modules=PROJECTIONS, modules_to_save=NORMS,
        task_type="CAUSAL_LM", lora_dropout=0.05))


@pytest.fixture(scope="module")
def peft_sd():
    """A PEFT-wrapped HF LLaMA's state dict as a stage-2 run leaves it: LoRA B
    and the modules_to_save copies trained (unlike the frozen originals)."""
    sd = {k: v.detach().clone() for k, v in _peft_llama(_llm_cfg()).state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if ".lora_B." in k:
            sd[k] = 0.1 * torch.randn(v.shape, generator=gen)
        elif ".modules_to_save." in k:
            sd[k] = 1.0 + 0.1 * torch.randn(v.shape, generator=gen)
    assert any(".original_module." in k for k in sd)
    assert any(".base_layer.weight" in k for k in sd)
    assert any(k.startswith("base_model.model.") for k in sd)
    return sd


@pytest.mark.parametrize("order", ["peft", "reversed"])
@pytest.mark.parametrize("shuffled", [False, True])
def test_llama_family_matches_jax(peft_sd, order, shuffled):
    sd = peft_sd if order == "peft" else dict(reversed(list(peft_sd.items())))
    added = _shuffled_added_tokens() if shuffled else None
    got, missing, unexpected = port.convert_llama(sd, num_layers=2, added_tokens=added)
    tree, jmissing, junexpected = conv.convert_llama(_np(sd), num_layers=2, added_tokens=added)
    assert (missing, unexpected) == (jmissing, junexpected) == ([], [])
    _assert_same(got, W.agent_state_dict(LlamaForCausalLM(_llm_cfg()), tree))
    # the trained modules_to_save copy wins over the frozen original
    key = "model.layers.1.input_layernorm.weight"
    assert torch.equal(got[key], sd[f"base_model.model.{key[:-7]}.modules_to_save.default.weight"])
    if shuffled:  # the canonical <img> row is the released <img> row, padding after
        released = sd["base_model.model.model.embed_tokens.weight"]
        assert torch.equal(got["model.embed_tokens.weight"][BOI_TOKEN_ID],
                           released[added["<img>"]])
        assert not got["lm_head.weight"][32066:].any()


def test_llama_family_reports_what_the_jax_converter_reports(peft_sd):
    """One layer of two, lm_head gone, a bias the projections do not have."""
    sd = dict(peft_sd)
    del sd["base_model.model.lm_head.weight"]
    sd["base_model.model.model.layers.0.mlp.up_proj.base_layer.bias"] = torch.zeros(352)
    got, missing, unexpected = port.convert_llama(sd, num_layers=1)
    tree, jmissing, junexpected = conv.convert_llama(_np(sd), num_layers=1)
    assert missing == jmissing == ["lm_head.weight"]
    assert unexpected == junexpected
    assert "model.layers.0.mlp.up_proj.base_layer.bias" in unexpected
    assert sum(k.startswith("model.layers.1.") for k in unexpected) == 2 + 7 * 3
    assert not any(k.startswith("model.layers.1.") for k in got)


def _agent_cfg(**llm):
    return AgentConfig.tiny(llm=_llm_cfg(**llm))


@pytest.fixture(scope="module")
def agent_bin(peft_sd, tmp_path_factory):
    """The agent bin (``llm.`` + the PEFT LLaMA, the two resamplers under
    Qwen's names, their sin-cos tables included) and a shuffled
    added_tokens.json, on disk. The released rows are the canonical ones
    permuted, so the canonical agent is known."""
    root = tmp_path_factory.mktemp("agent")
    added = _shuffled_added_tokens(seed=3)
    sd = {f"llm.{k}": v for k, v in peft_sd.items()}
    agent = ContinuousLVLM(_agent_cfg())
    for name in ("input_resampler", "output_resampler"):
        part = _random_sd(getattr(agent, name), seed=len(name))
        sd.update({f"{name}.{k}": v for k, v in part.items()})
    torch.save(sd, root / "pytorch_model.bin")
    (root / "added_tokens.json").write_text(json.dumps(added))
    return root, sd, added


def _convert_cli(root, out, *flags):
    return port.main(["--family", "agent", "--input", str(root / "pytorch_model.bin"),
                      "--output", str(out), "--num_layers", "2",
                      "--added_tokens_json", str(root / "added_tokens.json"), *flags])


@pytest.mark.parametrize("int8", [False, True])
def test_agent_cli_matches_jax(agent_bin, tmp_path, capsys, int8):
    root, sd, added = agent_bin
    missing, unexpected = _convert_cli(root, tmp_path / "agent.pt", *(["--int8"] if int8 else []))
    assert "missing keys: 0, unexpected keys: 0" in capsys.readouterr().out
    tree, jmissing, junexpected = conv.convert_agent(_np(sd), num_layers=2, added_tokens=added)
    assert (missing, unexpected) == (jmissing, junexpected) == ([], [])
    if int8:
        tree = ref_llama.quantize_llama_params(tree)
    module = ContinuousLVLM(_agent_cfg(quantize_base=int8))
    got = torch.load(tmp_path / "agent.pt", weights_only=True)
    _assert_same(got, W.agent_state_dict(module, tree))
    assert sum(v.dtype == torch.int8 for v in got.values()) == (7 * 2 if int8 else 0)


def test_int8_file_loads_as_written(agent_bin, tmp_path):
    """``load_checkpoint_`` loads an --int8 file's float entries, quantizes
    the float agent, then loads the int8 ones: the file holds no float
    projection weight, so its int8 weights and scales come through as written,
    not quantized again."""
    root, _, _ = agent_bin
    _convert_cli(root, tmp_path / "int8.pt", "--int8")
    saved = torch.load(tmp_path / "int8.pt", weights_only=True)
    projections = [k for k in saved if k.endswith(".weight")
                   and k.rpartition(".")[0].rpartition(".")[2] in PROJECTIONS]
    assert len(projections) == 7 * 2 and all(saved[k].dtype == torch.int8 for k in projections)
    agent = fill_module(ContinuousLVLM, _agent_cfg(), "cpu", seed=9)
    load_checkpoint_(agent, str(tmp_path / "int8.pt"),
                     lambda a: quantize_agent_(a, base=True, kv=False))
    _assert_same(saved, agent.state_dict())


def test_agent_from_the_cli_file_gives_the_jax_logits(agent_bin, tmp_path, capsys):
    root, sd, added = agent_bin
    _convert_cli(root, tmp_path / "agent.pt")
    agent = fill_module(ContinuousLVLM, _agent_cfg(), "cpu", seed=7).eval()
    capsys.readouterr()
    load_checkpoint_(agent, str(tmp_path / "agent.pt"))
    assert "missing keys: 0, unexpected keys: 0" in capsys.readouterr().out
    tree, _, _ = conv.convert_agent(_np(sd), num_layers=2, added_tokens=added)
    jmodel = ref_llama.LlamaForCausalLM(ref_llama.LlamaConfig.tiny(dtype=jnp.float32,
                                                                   lora_rank=LORA))
    ids = np.random.RandomState(4).randint(100, 32066, size=(2, 14))
    ids[:, 3:6] = [BOI_TOKEN_ID, BOI_TOKEN_ID + 1, BOI_TOKEN_ID + 40]  # permuted rows
    want = np.asarray(jmodel.apply({"params": tree["llm"]}, jnp.asarray(ids))["logits"])
    with torch.no_grad():
        got = agent.llm(torch.from_numpy(ids))["logits"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("extras", [False, True])
def test_qwen_vit_family_matches_jax(extras):
    vit = VisionTransformerWithAttnPool(ViTConfig.tiny(dtype=torch.float32))
    sd = _random_sd(vit, seed=2)
    if extras:  # a stray entry, and a sin-cos table that is not there
        sd["transformer.extra.weight"] = torch.ones(3)
        del sd["attn_pool.pos_embed"]
    got, missing, unexpected = port.convert_qwen_vit(sd, layers=2)
    tree, jmissing, junexpected = conv.convert_qwen_vit(_np(sd), layers=2)
    assert (missing, unexpected) == (jmissing, junexpected)
    assert (missing, unexpected) == ((["attn_pool.pos_embed"], ["transformer.extra.weight"])
                                     if extras else ([], []))
    _assert_same(got, W.vit_state_dict(vit, tree))


def _unet_sd(adapter):
    return {k[len("unet."):]: v for k, v in _random_sd(adapter, seed=5).items()
            if k.startswith("unet.")}


@pytest.mark.parametrize("family", ["sdxl_unet", "sdxl_vae", "detokenizer"])
def test_diffusers_families_match_jax(family):
    if family == "sdxl_vae":
        module = AutoencoderKL(VAEConfig.tiny())
        sd, to_sd = _random_sd(module, seed=6), W.vae_state_dict
    else:
        module = SDXLAdapter(SDXLAdapterConfig.tiny())
        sd, to_sd = _random_sd(module, seed=5), W.adapter_state_dict
        if family == "sdxl_unet":
            module, sd = module.unet, _unet_sd(module)
    got, missing, unexpected = getattr(port, f"convert_{family}")(sd)
    tree, jmissing, junexpected = getattr(conv, f"convert_{family}")(_np(sd))
    assert (missing, unexpected) == (jmissing, junexpected) == ([], [])
    _assert_same(got, to_sd(module, tree))


@pytest.mark.parametrize("nested", [False, True])
def test_yuying_remap_equals_jax_key_for_key(nested):
    rng = np.random.RandomState(0)
    inner = {
        "query_tokens": rng.randn(1, 32, 24).astype(np.float32),
        "ln_vision.weight": rng.randn(24).astype(np.float32),
        "ln_vision.bias": rng.randn(24).astype(np.float32),
        "Qformer.bert.encoder.layer.0.attention.self.query.weight":
            rng.randn(24, 24).astype(np.float32),
        "Qformer.cls.predictions.bias": rng.randn(50).astype(np.float32),
        "visual_encoder.blocks.0.attn.qkv.weight": rng.randn(8, 8).astype(np.float32),
    }
    sd = {"model": inner} if nested else inner
    want = conv.remap_stage1_yuying(sd)
    got = port.remap_stage1_yuying({"model": {k: torch.from_numpy(v) for k, v in inner.items()}}
                                   if nested else {k: torch.from_numpy(v)
                                                   for k, v in inner.items()})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_legacy_ip_adapter_matches_jax():
    dims = dict(dim=64, depth=2, dim_head=16, heads=4, num_queries=8, embedding_dim=48,
                output_dim=96)
    resampler = IPAResampler(**dims)
    sd = {f"image_proj_model.{k}": v for k, v in _random_sd(resampler, seed=8).items()}
    gen = torch.Generator().manual_seed(9)
    for i in range(3):
        for name in ("to_k_ip", "to_v_ip"):
            sd[f"adapter_modules.{i}.{name}.weight"] = torch.randn(32, 96, generator=gen)
    sd["adapter_modules.0.to_out.weight"] = torch.zeros(4, 4)  # not an IP layer
    got, missing, unexpected = port.convert_ip_adapter_legacy(sd)
    tree, jmissing, junexpected = conv.convert_ip_adapter_legacy(_np(sd))
    assert (missing, unexpected) == (jmissing, junexpected)
    assert unexpected == ["adapter_modules.0.to_out.weight"]
    proj = {k[len("image_proj_model."):]: v for k, v in got.items()
            if k.startswith("image_proj_model.")}
    _assert_same(proj, W.ipa_adapter_state_dict(resampler, tree["image_proj_model"]))
    layers = {k: v for k, v in got.items() if k.startswith("ip_layers.")}
    assert len(layers) == 6
    for i in range(3):
        for name in ("to_k_ip", "to_v_ip"):
            kernel = tree["ip_layers"][f"layers_{i}"][name]["kernel"]
            np.testing.assert_array_equal(layers[f"ip_layers.{i}.{name}.weight"].numpy(),
                                          kernel.T)


@pytest.mark.parametrize("fault", [None, "missing", "extra"])
def test_added_token_permutation_matches_jax(fault):
    added = _shuffled_added_tokens(seed=1)
    if fault == "missing":
        del added["<img>"]
    elif fault == "extra":
        added["<oops>"] = 99
    if fault is not None:  # a wrong token set is refused by both
        with pytest.raises(ValueError, match="added-token set mismatch"):
            conv.added_token_permutation(added)
        with pytest.raises(ValueError, match="added-token set mismatch"):
            port.added_token_permutation(added)
        return
    perm = port.added_token_permutation(added)
    np.testing.assert_array_equal(perm.numpy(), conv.added_token_permutation(added))
    w = torch.arange(32128, dtype=torch.float32)[:, None]
    np.testing.assert_array_equal(port.remap_embedding_rows(w, perm).numpy(),
                                  conv.remap_embedding_rows(w.numpy(), perm.numpy()))


@pytest.mark.parametrize("flag", ["--int8", "--scan_layers", "--added_tokens_json"])
def test_cli_refuses_llm_flags_for_other_families(tmp_path, flag):
    torch.save({"encoder.conv_in.weight": torch.ones(2, 2, 3, 3)}, tmp_path / "vae.bin")
    extra = [flag] + ([str(tmp_path / "added.json")] if flag == "--added_tokens_json" else [])
    (tmp_path / "added.json").write_text(json.dumps(_shuffled_added_tokens()))
    with pytest.raises(SystemExit):
        port.main(["--family", "sdxl_vae", "--input", str(tmp_path / "vae.bin"),
                   "--output", str(tmp_path / "vae.pt"), *extra])
    assert not (tmp_path / "vae.pt").exists()


def test_cli_ignores_scan_layers_and_keeps_a_bf16_bin_bf16(peft_sd, tmp_path, capsys):
    """The JAX tool's ``.numpy()`` raises on a bf16 tensor; the port keeps
    the stored dtype."""
    torch.save({k: v.to(torch.bfloat16) for k, v in peft_sd.items()}, tmp_path / "llama.bin")
    port.main(["--family", "llama", "--input", str(tmp_path / "llama.bin"),
               "--output", str(tmp_path / "llama.pt"), "--num_layers", "2", "--scan_layers"])
    out = capsys.readouterr().out
    assert "--scan_layers has no effect" in out and f"saved to {tmp_path / 'llama.pt'}" in out
    got = torch.load(tmp_path / "llama.pt", weights_only=True)
    assert got["model.embed_tokens.weight"].dtype == torch.bfloat16
    want, _, _ = port.convert_llama(peft_sd, num_layers=2)
    for k, v in want.items():
        assert torch.equal(got[k], v.to(torch.bfloat16)), k


def _script_args(name):
    """(module, argv) of the ``torchrun ... -m module`` line of a launch script."""
    with open(os.path.join(REPO, "scripts", name)) as f:
        text = f.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "torchrun" in ln)
    words = shlex.split(line)
    assert words[words.index("torchrun") + 1:words.index("-m")] == ["--nproc_per_node", "8"]
    module = words[words.index("-m") + 1]
    argv = words[words.index("-m") + 2:]
    assert argv[-1] == "$@"
    return module, argv[:-1]


@pytest.mark.parametrize("script, module", [
    ("sft_storystream_torch.sh", "seed_story_torch.train.train_clm_sft"),
    ("adapt_storystream_torch.sh", "seed_story_torch.train.train_sdxl_img2img_llm"),
])
def test_launch_scripts_parse_with_their_entries(script, module):
    import importlib

    got_module, argv = _script_args(script)
    assert got_module == module
    args = importlib.import_module(module).parse_args(argv)
    assert args.sharding == "fsdp" and args.mesh_data == 8
    for key, value in vars(args).items():
        if isinstance(value, str) and value.startswith("configs/"):
            assert os.path.exists(os.path.join(REPO, value)), (key, value)
    # the same flags as the JAX script, the converter's files for the weights
    with open(os.path.join(REPO, "scripts", script.replace("_torch", ""))) as f:
        jax_flags = {w for w in shlex.split(f.read().replace("\\\n", " ")) if w.startswith("--")}
    flags = {w for w in argv if w.startswith("--")}
    assert flags - {"--mesh_data"} == jax_flags
    for key, value in vars(args).items():
        if key.startswith("pretrained_") and value:
            assert value.endswith(".pt"), (key, value)


def test_chip_smoke_writes_the_peft_layout(peft_sd):
    """The smoke's released-layout writer (it has no peft on the card) gives
    PEFT's own names, and the converter gives the agent back from it."""
    import chip_smoke

    agent = fill_module(ContinuousLVLM, _agent_cfg(), "cpu", seed=2)
    with torch.no_grad():  # the padding rows, zero in a converted file
        agent.llm.model.embed_tokens.weight[32066:] = 0
        agent.llm.lm_head.weight[32066:] = 0
    added = _shuffled_added_tokens(seed=5)
    released = chip_smoke.released_agent_state_dict(agent, added)
    assert {k for k in released if k.startswith("llm.")} == {f"llm.{k}" for k in peft_sd}
    got, missing, unexpected = port.convert_agent(released, num_layers=2, added_tokens=added)
    assert missing == [] and unexpected == []
    _assert_same(got, agent.state_dict())
