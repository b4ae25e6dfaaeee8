"""Released torch checkpoints -> the port's parameter files; counterpart of
``seed_story_tpu/tools/convert_torch_weights.py`` with the same families and
flags.

    python -m seed_story_torch.tools.convert_torch_weights --family agent \\
        --input pytorch_model.bin --output agent.pt \\
        [--num_layers 32] [--int8] [--added_tokens_json added_tokens.json]

Families: ``qwen_vit`` (the ViT-bigG extracted by ``tools/reload_qwen_vit``),
``llama`` (HF LLaMA-2, bare or PEFT-wrapped), ``agent`` (the SEED agent bin:
``llm.*`` + ``input_resampler.*`` / ``output_resampler.*``), ``sdxl_unet``,
``sdxl_vae`` and ``detokenizer`` (the SDXLAdapter bin: ``resampler.*`` +
``unet.*``). The output is a ``train/checkpoint.py::save_params`` file, which
the CLIs' ``--*_ckpt`` flags and the trainers' ``--pretrained_*_path`` flags
read through ``load_checkpoint_``.

The port's modules keep the torch names (HF LLaMA + PEFT LoRA, Qwen's ViT and
resampler, diffusers' UNet and VAE, the perceiver's ``layers.N.0/1.*``), so no
layout changes: the work is the PEFT key normalisation, the vocab rows (the
released added-token order permuted to the canonical one, then padding to
the padded vocab), dropping the frozen sin-cos ``pos_embed`` tables (the
modules compute their own), and ``--int8``. Tensors keep their stored dtype.

Each converter takes a flat {name: tensor} state dict and returns (state
dict, missing, unexpected) with strict=False semantics: ``missing`` names the
entries the converter looked for and did not find, ``unexpected`` what it
left over, as the JAX converters report them.
"""

from __future__ import annotations

import argparse
import json
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]
Report = Tuple[StateDict, List[str], List[str]]

LLM_FAMILIES = ("llama", "agent")


def _tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


class _Builder:
    """Takes entries out of a state dict into the output, recording the ones
    it looked for and did not find; what is left over is unexpected."""

    def __init__(self, sd):
        self.sd = dict(sd)
        self.out: StateDict = {}
        self.missing: List[str] = []

    def take(self, key: str, transform=None) -> None:
        if key not in self.sd:
            self.missing.append(key)
            return
        v = _tensor(self.sd.pop(key))
        self.out[key] = transform(v) if transform else v

    def take_present(self, key: str) -> None:
        if key in self.sd:
            self.take(key)

    def drop(self, key: str) -> None:
        """A frozen buffer the module computes itself: taken, not written."""
        if self.sd.pop(key, None) is None:
            self.missing.append(key)

    def linear(self, prefix: str, bias: bool = True) -> None:
        self.take(prefix + ".weight")
        if bias:
            self.take_present(prefix + ".bias")

    def norm(self, prefix: str) -> None:
        self.take(prefix + ".weight")
        self.take_present(prefix + ".bias")

    def done(self) -> Report:
        return self.out, self.missing, sorted(self.sd)


def _prefixed(report: Report, prefix: str) -> Report:
    out, missing, unexpected = report
    return ({prefix + k: v for k, v in out.items()}, [prefix + k for k in missing],
            [prefix + k for k in unexpected])


# ---------------------------------------------------------------------
# Qwen ViT (reference src/models/qwen_visual.py state dict)
# ---------------------------------------------------------------------


def convert_qwen_vit(sd, layers: int = 48) -> Report:
    b = _Builder(sd)
    b.take("conv1.weight")
    b.take("positional_embedding")
    b.norm("ln_pre")
    b.norm("ln_post")
    b.take("proj")
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        b.norm(f"{p}.ln_1")
        b.norm(f"{p}.ln_2")
        for name in ("attn.in_proj", "attn.out_proj", "mlp.c_fc", "mlp.c_proj"):
            b.linear(f"{p}.{name}")
    b.take("attn_pool.query")
    b.linear("attn_pool.kv_proj", bias=False)
    b.norm("attn_pool.ln_q")
    b.norm("attn_pool.ln_kv")
    b.take("attn_pool.attn.in_proj_weight")
    b.take("attn_pool.attn.in_proj_bias")
    b.linear("attn_pool.attn.out_proj")
    b.drop("attn_pool.pos_embed")
    return b.done()


# ---------------------------------------------------------------------
# LLaMA (HF base + optional PEFT LoRA + resized embeddings)
# ---------------------------------------------------------------------


def normalize_peft_keys(sd) -> StateDict:
    """PEFT-wrapped names -> HF names, with the JAX converter's replacements
    in its order; the frozen ``original_module`` copies that PEFT keeps
    beside every ``modules_to_save`` trained copy are dropped, so the trained
    copy is the one kept, whichever order the keys come in."""
    out: StateDict = {}
    for k, v in sd.items():
        if ".original_module." in k:
            continue
        k = k.replace("base_model.model.", "")
        k = k.replace(".base_layer.weight", ".weight")  # peft >= 0.7 wrapping
        k = k.replace(".default.weight", ".weight")  # lora_A.default.weight
        k = k.replace(".modules_to_save.weight", ".weight")
        out[k] = v
    return out


def convert_llama(sd, num_layers: int = 32, vocab_padded: int = 32128,
                  added_tokens: Optional[Dict[str, int]] = None) -> Report:
    """HF ``LlamaForCausalLM`` state dict (bare or PEFT-wrapped) -> the port's
    ``LlamaForCausalLM`` state dict. ``added_tokens`` ({token: released id},
    the released tokenizer's added_tokens.json) reorders the embed_tokens and
    lm_head rows from the released added-token order to the canonical 32000+
    layout; the rows are then padded with zeros to ``vocab_padded``."""
    b = _Builder(normalize_peft_keys(sd))
    perm = added_token_permutation(added_tokens) if added_tokens else None

    def pad_vocab(w):
        if perm is not None and w.shape[0] >= perm.shape[0]:
            w = remap_embedding_rows(w, perm)
        if w.shape[0] < vocab_padded:
            w = torch.cat([w, w.new_zeros((vocab_padded - w.shape[0],) + tuple(w.shape[1:]))])
        return w

    b.take("model.embed_tokens.weight", pad_vocab)
    b.take("lm_head.weight", pad_vocab)
    b.norm("model.norm")
    for i in range(num_layers):
        p = f"model.layers.{i}"
        b.norm(f"{p}.input_layernorm")
        b.norm(f"{p}.post_attention_layernorm")
        for proj in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                     "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"):
            b.linear(f"{p}.{proj}", bias=False)
            b.take_present(f"{p}.{proj}.lora_A.weight")
            b.take_present(f"{p}.{proj}.lora_B.weight")
    return b.done()


def convert_qwen_resampler(sd, prefix: str = "") -> Report:
    """The agent's input/output Resampler (qwen style); the output's names
    are without ``prefix``."""
    b = _Builder({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    b.take("query")
    if prefix + "kv_proj.weight" in sd:
        # kv_proj exists only when kv_dim != embed_dim (qwen_visual.py:108);
        # the 7B agent resamplers are 4096->4096 and have none
        b.linear("kv_proj", bias=False)
    b.norm("ln_q")
    b.norm("ln_kv")
    b.take("attn.in_proj_weight")
    b.take("attn.in_proj_bias")
    b.linear("attn.out_proj")
    b.drop("pos_embed")
    return b.done()


def convert_agent(sd, num_layers: int = 32,
                  added_tokens: Optional[Dict[str, int]] = None) -> Report:
    """SEED agent bin (the consolidated ``pytorch_model.bin`` of stage 2):
    ``llm.*`` (PEFT LLaMA) + ``input_resampler.*`` / ``output_resampler.*``."""
    out: StateDict = {}
    missing: List[str] = []
    unexpected: List[str] = []
    parts = []
    llm_sd = {k[len("llm."):]: v for k, v in sd.items() if k.startswith("llm.")}
    if llm_sd:
        parts.append(_prefixed(convert_llama(llm_sd, num_layers=num_layers,
                                             added_tokens=added_tokens), "llm."))
    for name in ("input_resampler", "output_resampler"):
        sub = {k: v for k, v in sd.items() if k.startswith(name + ".")}
        if sub:
            parts.append(_prefixed(convert_qwen_resampler(sub, prefix=name + "."), name + "."))
    for part, m, u in parts:
        out.update(part)
        missing += m
        unexpected += u
    return out, missing, unexpected


# ---------------------------------------------------------------------
# SDXL UNet / VAE (diffusers state dicts) and the perceiver resamplers
# ---------------------------------------------------------------------


def convert_sdxl_unet(sd) -> Report:
    """diffusers ``UNet2DConditionModel`` state dict -> the port's UNet's,
    whose names are diffusers' own."""
    return {k: _tensor(v) for k, v in sd.items()}, [], []


def convert_sdxl_vae(sd) -> Report:
    """diffusers ``AutoencoderKL`` state dict -> the port's VAE's (diffusers'
    names)."""
    return {k: _tensor(v) for k, v in sd.items()}, [], []


_IPA_TOP = ("proj_in.", "proj_out.", "norm_out.", "unet_proj_1.", "unet_proj_2.",
            "unet_attnpool.")


def convert_ipa_resampler(sd) -> StateDict:
    """open-flamingo-style perceiver Resampler state dict (the detokenizer's
    ResamplerXL(V2) and the IP-Adapter's image_proj_model) -> the port's, the
    names being the reference's own (``layers.N.0`` attention, ``layers.N.1``
    feed-forward). Entries the JAX converter does not read are left out."""
    return {k: _tensor(v) for k, v in sd.items()
            if re.match(r"layers\.\d+\.\d+\.", k) or k == "latents" or k.startswith(_IPA_TOP)}


def convert_detokenizer(sd) -> Report:
    """SDXLAdapter bin (the reference's detokenizer checkpoints): resampler.* +
    unet.* -> the port's ``SDXLAdapter`` state dict."""
    out = {k: _tensor(v) for k, v in sd.items() if k.startswith("unet.")}
    res = convert_ipa_resampler({k[len("resampler."):]: v for k, v in sd.items()
                                 if k.startswith("resampler.")})
    out.update({"resampler." + k: v for k, v in res.items()})
    return out, [], []


# ---------------------------------------------------------------------
# Released legacy layouts
# ---------------------------------------------------------------------


def remap_stage1_yuying(sd) -> StateDict:
    """Legacy BLIP2-style stage-1 checkpoint -> the canonical reference
    discrete-model layout (the key remap of the reference's
    ``from_pretrained_stage1_yuying``, src/models/discrete_models.py:427-454):
    the bin is ``{'model': {...}}`` with ``query_tokens`` / ``ln_vision.*`` /
    ``Qformer.*`` keys."""
    if "model" in sd and not any("." in k for k in sd if k != "model"):
        inner = sd["model"]
        if isinstance(inner, dict):
            sd = inner
    out: StateDict = {}
    if "query_tokens" in sd:
        query = _tensor(sd["query_tokens"])
        if query.shape[0] != 1:
            raise ValueError(f"query_tokens of shape {tuple(query.shape)}: expected (1, n, d)")
        out["qformer.embed_module.query"] = query[0]
    if "ln_vision.weight" in sd:
        out["qformer.norm.weight"] = _tensor(sd["ln_vision.weight"])
    if "ln_vision.bias" in sd:
        out["qformer.norm.bias"] = _tensor(sd["ln_vision.bias"])
    for key, v in sd.items():
        if key.startswith("Qformer"):
            out[key.replace("Qformer", "qformer.perceiver")] = _tensor(v)
    return out


def split_ip_adapter_legacy(sd) -> Tuple[StateDict, StateDict]:
    """Legacy IP-Adapter bin -> (image_proj sd, ip_layers sd), the split of the
    reference's ``from_pretrained_legacy`` (src/models_ipa/adapter_modules.py:
    116-137): ``image_proj_model.*`` keys feed the perceiver resampler,
    ``adapter_modules.*`` keys the decoupled to_k_ip/to_v_ip layers."""
    image_proj: StateDict = {}
    ip_layers: StateDict = {}
    for key, v in sd.items():
        if key.startswith("image_proj_model."):
            image_proj[key[len("image_proj_model."):]] = v
        elif key.startswith("adapter_modules."):
            ip_layers[key[len("adapter_modules."):]] = v
    return image_proj, ip_layers


def convert_ip_adapter_legacy(sd) -> Report:
    """Legacy IP-Adapter bin -> ``image_proj_model.*`` (the port's
    ``IPAResampler`` names) and ``ip_layers.<i>.to_k_ip.weight`` /
    ``ip_layers.<i>.to_v_ip.weight``: layer i's ``IPCrossAttention``
    entries, in the torch (out, in) layout."""
    proj_sd, ip_sd = split_ip_adapter_legacy(sd)
    out = {f"image_proj_model.{k}": v for k, v in convert_ipa_resampler(proj_sd).items()}
    unexpected: List[str] = []
    for key, v in ip_sd.items():
        m = re.fullmatch(r"(\d+)\.(to_[kv]_ip)\.weight", key)
        if m is None:
            unexpected.append(f"adapter_modules.{key}")
            continue
        out[f"ip_layers.{int(m.group(1))}.{m.group(2)}.weight"] = _tensor(v)
    return out, [], unexpected


# ---------------------------------------------------------------------
# Vocab rows and int8
# ---------------------------------------------------------------------


def added_token_permutation(added_tokens: Dict[str, int]) -> torch.Tensor:
    """Row permutation fixing a released tokenizer whose added tokens were
    saved in another order than the canonical layout (``data/tokenizer.py``):
    ``perm[canonical_id] = released_id`` over the 32066 ids, identity on the
    base 32000. Apply to embed_tokens / lm_head rows: ``w_canonical =
    w_released[perm]``. ``added_tokens`` is the released added_tokens.json
    mapping {token: released id}; it must cover exactly the 66 multimodal
    tokens, else ValueError."""
    from ..data.tokenizer import LLAMA_VOCAB_SIZE, special_tokens

    specials = special_tokens()
    if sorted(added_tokens) != sorted(specials):
        extra = sorted(set(added_tokens) - set(specials))
        miss = sorted(set(specials) - set(added_tokens))
        raise ValueError(f"added-token set mismatch: unexpected {extra}, missing {miss}")
    perm = torch.arange(LLAMA_VOCAB_SIZE + len(specials))
    for i, tok in enumerate(specials):
        perm[LLAMA_VOCAB_SIZE + i] = added_tokens[tok]
    return perm


def remap_embedding_rows(w: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Reorders vocab rows (embed_tokens / lm_head) from the released
    added-token order to the canonical layout; rows past ``perm`` (padding)
    stay as they are."""
    out = w.clone()
    out[:perm.shape[0]] = w[perm]
    return out


def quantize_projections(sd: StateDict) -> StateDict:
    """The seven LLaMA projections' ``weight`` -> int8 ``weight`` and f32
    ``weight_scale`` (``models/llama.py::quantize_weight``, what
    ``quantize_llama_`` does in place and ``load_checkpoint_`` reads back);
    everything else (LoRA, norms, embeddings, lm_head, resamplers) as it is."""
    from ..models.llama import QUANT_MODULES, quantize_weight

    out: StateDict = {}
    for k, v in sd.items():
        owner, _, leaf = k.rpartition(".")
        if leaf == "weight" and owner.rpartition(".")[2] in QUANT_MODULES and v.dim() == 2:
            out[k], out[owner + ".weight_scale"] = quantize_weight(v)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------


def load_torch_state_dict(path: str) -> StateDict:
    """A torch checkpoint's flat state dict, each tensor in its stored dtype
    (a bf16 bin stays bf16)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: _tensor(v) for k, v in sd.items()}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", required=True,
                   choices=["qwen_vit", "llama", "agent", "sdxl_unet", "sdxl_vae",
                            "detokenizer"])
    p.add_argument("--input", required=True, help=".pt/.bin torch checkpoint")
    p.add_argument("--output", required=True, help="parameter file (save_params)")
    p.add_argument("--num_layers", type=int, default=None)
    p.add_argument("--scan_layers", action="store_true",
                   help="the JAX package's stacked-layer layout; the port keeps per-layer "
                        "modules, so it has no effect here (llama/agent families)")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 projection weights with per-output-channel "
                        "scales (quantize_llama_; llama/agent families)")
    p.add_argument("--added_tokens_json", default=None,
                   help="released tokenizer's added_tokens.json; if its 66 multimodal "
                        "tokens were saved in another order than special_tokens(), "
                        "embed/lm_head rows 32000+ are permuted to the canonical layout "
                        "(llama/agent families)")
    return p, p.parse_args(argv)


def main(argv=None) -> Tuple[List[str], List[str]]:
    """Converts, prints the missing and unexpected counts, writes the file;
    returns (missing, unexpected)."""
    from ..train.checkpoint import save_params

    p, a = parse_args(argv)
    added_tokens = None
    if a.added_tokens_json:
        if a.family not in LLM_FAMILIES:
            p.error("--added_tokens_json applies to the llama/agent families")
        with open(a.added_tokens_json) as f:
            added_tokens = json.load(f)

    sd = load_torch_state_dict(a.input)
    conv = {
        "qwen_vit": lambda: convert_qwen_vit(sd, layers=a.num_layers or 48),
        "llama": lambda: convert_llama(sd, num_layers=a.num_layers or 32,
                                       added_tokens=added_tokens),
        "agent": lambda: convert_agent(sd, num_layers=a.num_layers or 32,
                                       added_tokens=added_tokens),
        "sdxl_unet": lambda: convert_sdxl_unet(sd),
        "sdxl_vae": lambda: convert_sdxl_vae(sd),
        "detokenizer": lambda: convert_detokenizer(sd),
    }[a.family]
    out, missing, unexpected = conv()
    del sd
    print(f"missing keys: {len(missing)}, unexpected keys: {len(unexpected)}")
    if a.int8:
        if a.family not in LLM_FAMILIES:
            p.error("--int8 applies to the llama/agent families")
        out = quantize_projections(out)
    if a.scan_layers:
        if a.family not in LLM_FAMILIES:
            p.error("--scan_layers applies to the llama/agent families")
        print("--scan_layers has no effect in the port: it keeps per-layer modules")
    save_params(a.output, out)
    print(f"saved to {a.output}")
    return missing, unexpected


if __name__ == "__main__":
    main()
