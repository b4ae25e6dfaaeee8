"""The plain float32 reference of the story agent: ViT-bigG with attention
pooling, the LLaMA-architecture LLM with LoRA, the two Qwen resamplers, the
word tokenizer and prompt layout of the story flow, and the forced image-token
rule of greedy decoding.

Parameter names are those of the released checkpoints (``qwen_visual``, HF
LLaMA with PEFT LoRA, the agent's ``input_resampler`` / ``output_resampler``),
which the program keeps, so one seeded weight stream fills both. The LLM
runs teacher-forced over a prompt and the tokens served for it: one causal
forward in float32, attention over the whole sequence, no cache.
"""

from __future__ import annotations

import math
import re
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import Lin, Norm, QwenResampler, attention, resize_pos

# The word tokenizer with the LLaMA id layout of the story flow: words hash
# into [100, 31999]; <img>, </img> and the 64 image tokens sit at 32000+;
# bos 1, eos 2, pad 0.
BOI_ID, EOI_ID, FIRST_IMG_ID, BASE_VOCAB = 32000, 32001, 32002, 32000
IMG_TOKEN = "<img_{:05d}>"
_WORD_RE = re.compile(r"<img_\d{5}>|</?img>|\[INST\]|\[/INST\]|[A-Za-z0-9']+|[^\sA-Za-z0-9]")
_TAG_RE = re.compile(r"\s*<[^>]*>\s*")
_SPECIAL = {"<img>": BOI_ID, "</img>": EOI_ID, "[INST]": 29961, "[/INST]": 29962,
            **{IMG_TOKEN.format(i): FIRST_IMG_ID + i for i in range(64)}}
_INV = {v: k for k, v in _SPECIAL.items()}


def image_block(n: int) -> str:
    return "<img>" + "".join(IMG_TOKEN.format(i) for i in range(n)) + "</img>"


def encode(text: str) -> List[int]:
    ids = []
    for w in _WORD_RE.findall(text):
        if w in _SPECIAL:
            ids.append(_SPECIAL[w])
        else:
            h = 0
            for ch in w:
                h = (h * 131 + ord(ch)) % (BASE_VOCAB - 200)
            ids.append(100 + h)
    return ids


def clean_text(ids) -> str:
    """The served tokens as the next prompt takes them: decoded, every tag
    (<...>) cut out."""
    words = []
    for i in (int(t) for t in ids):
        if i in (0, 1, 2):
            continue
        words.append(_INV.get(i, f"w{i}"))
    return _TAG_RE.sub(" ", " ".join(words)).strip()


def prompt_ids(caption: str, texts: Sequence[str], n_img_tokens: int, window: int):
    """(ids, comprehension mask) of a story's prompt after ``texts`` (the
    segments served so far): bos, the caption and the start image's block,
    then each segment's text and its image's block; beyond ``window``
    images the oldest "...</img>[INST]" span is cut."""
    block = image_block(n_img_tokens)
    prompt = caption + block
    n_images = 1
    for text in texts:
        prompt += text + block
        n_images += 1
        while n_images > window:
            cut = prompt.index("</img>") + len("</img>") + len("[INST]")
            prompt = prompt[cut:]
            n_images -= 1
    ids = np.asarray([1] + encode(prompt), np.int64)
    cmp = np.zeros(len(ids), bool)
    boi, eoi = np.flatnonzero(ids == BOI_ID), np.flatnonzero(ids == EOI_ID)
    for i in range(n_images):
        cmp[boi[i] + 1:eoi[i]] = True
    return ids, cmp


def forced_chain(n_gen: int) -> dict:
    chain = [BOI_ID] + [FIRST_IMG_ID + i for i in range(n_gen)] + [EOI_ID]
    return dict(zip(chain[:-1], chain[1:]))


def choice_scores(logits: torch.Tensor, prev: Sequence[int], n_gen: int):
    """The scores greedy decoding picks from, (T, V), and which positions
    are forced: after a token of the image chain its successor is forced;
    elsewhere the image tokens and </img> score 0."""
    forced = forced_chain(n_gen)
    is_forced = torch.tensor([int(p) in forced for p in prev], device=logits.device)
    scores = logits.clone()
    scores[:, FIRST_IMG_ID:FIRST_IMG_ID + n_gen] = 0.0
    scores[:, EOI_ID] = 0.0
    return torch.where(is_forced[:, None], logits, scores), is_forced


# --- models ---------------------------------------------------------------

class Proj(Lin):
    """A LLaMA projection: W x plus (alpha / r) B A x."""

    def __init__(self, n_in: int, n_out: int, rank: int, alpha: float):
        super().__init__(n_in, n_out, bias=False)
        self.scaling = alpha / rank if rank else 0.0
        if rank:
            self.lora_A = Lin(n_in, rank, bias=False)
            self.lora_B = Lin(rank, n_out, bias=False)

    def forward(self, x):
        y = F.linear(x, self.weight)
        if self.scaling:
            y = y + self.scaling * self.lora_B(self.lora_A(x))
        return y


class Layer(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d, r, a = c["hidden_size"], c["lora_rank"], c["lora_alpha"]
        hkv = c.get("num_key_value_heads") or c["num_attention_heads"]
        hd = d // c["num_attention_heads"]
        self.input_layernorm = Norm(d, c["rms_norm_eps"], bias=False)
        self.post_attention_layernorm = Norm(d, c["rms_norm_eps"], bias=False)
        self.self_attn = nn.Module()
        for name, n_in, n_out in (("q_proj", d, d), ("k_proj", d, hkv * hd),
                                  ("v_proj", d, hkv * hd), ("o_proj", d, d)):
            setattr(self.self_attn, name, Proj(n_in, n_out, r, a))
        self.mlp = nn.Module()
        for name, n_in, n_out in (("gate_proj", d, c["intermediate_size"]),
                                  ("up_proj", d, c["intermediate_size"]),
                                  ("down_proj", c["intermediate_size"], d)):
            setattr(self.mlp, name, Proj(n_in, n_out, r, a))


class Llama(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.model = nn.Module()
        self.model.embed_tokens = nn.Module()
        self.model.embed_tokens.weight = nn.Parameter(
            torch.empty(c["padded_vocab_size"], c["hidden_size"]), requires_grad=False)
        self.model.layers = nn.ModuleList(Layer(c) for _ in range(c["num_hidden_layers"]))
        self.model.norm = Norm(c["hidden_size"], c["rms_norm_eps"], bias=False)
        self.lm_head = Lin(c["hidden_size"], c["padded_vocab_size"], bias=False)

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states of one causal pass over x (1, S, D)."""
        c = self.c
        h = c["num_attention_heads"]
        hkv = c.get("num_key_value_heads") or h
        hd = c["hidden_size"] // h
        s = x.shape[1]
        pos = torch.arange(s, device=x.device, dtype=torch.float32)
        inv = 1.0 / c["rope_theta"] ** (torch.arange(0, hd, 2, device=x.device,
                                                     dtype=torch.float32) / hd)
        ang = pos[:, None] * inv[None]
        cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()

        def rope(t):
            half = t.shape[-1] // 2
            rot = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
            return t * cos + rot * sin

        for layer in self.model.layers:
            a = layer.self_attn
            y = layer.input_layernorm(x)
            q = a.q_proj(y).view(1, s, h, hd).transpose(1, 2)
            k = a.k_proj(y).view(1, s, hkv, hd).transpose(1, 2)
            v = a.v_proj(y).view(1, s, hkv, hd).transpose(1, 2)
            q, k = rope(q), rope(k)
            if hkv != h:
                k, v = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
            o = attention(q, k, v, causal=True).transpose(1, 2).reshape(1, s, -1)
            x = x + a.o_proj(o)
            m = layer.mlp
            y = layer.post_attention_layernorm(x)
            x = x + m.down_proj(F.silu(m.gate_proj(y)) * m.up_proj(y))
        return self.model.norm(x)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        out = self.lm_head(hidden)
        out[..., self.c["vocab_size"]:] = -1e9
        return out


class ViT(nn.Module):
    """Qwen-VL ViT-bigG: patchify, bicubic position table, ln_pre, pre-LN
    blocks (fused qkv interleaved per head, exact GELU), attention pool to
    ``n_queries``, ln_post, projection."""

    def __init__(self, v: dict):
        super().__init__()
        w, eps = v["width"], v["ln_eps"]
        self.v = v
        self.conv1 = nn.Module()
        self.conv1.weight = nn.Parameter(torch.empty(w, 3, v["patch_size"], v["patch_size"]),
                                         requires_grad=False)
        self.positional_embedding = nn.Parameter(torch.empty(256, w), requires_grad=False)
        self.ln_pre = Norm(w, eps)
        self.transformer = nn.Module()
        blocks = []
        for _ in range(v["layers"]):
            blk = nn.Module()
            blk.ln_1, blk.ln_2 = Norm(w, eps), Norm(w, eps)
            blk.attn = nn.Module()
            blk.attn.in_proj, blk.attn.out_proj = Lin(w, 3 * w), Lin(w, w)
            blk.mlp = nn.Module()
            mlp = int(w * v["mlp_ratio"])
            blk.mlp.c_fc, blk.mlp.c_proj = Lin(w, mlp), Lin(mlp, w)
            blocks.append(blk)
        self.transformer.resblocks = nn.ModuleList(blocks)
        e = v["output_dim"]
        self.attn_pool = QwenResampler(int(math.isqrt(v["n_queries"])), e, max(1, e // 128), w,
                                       eps)
        self.ln_post = Norm(e, eps)
        self.proj = nn.Parameter(torch.empty(e, e), requires_grad=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        v = self.v
        x = F.conv2d(pixels, self.conv1.weight, stride=v["patch_size"])
        x = x.flatten(2).transpose(1, 2)
        x = x + resize_pos(self.positional_embedding, x.shape[1])[None]
        x = self.ln_pre(x)
        b, l, e = x.shape
        heads = v["heads"]
        hd = e // heads
        for blk in self.transformer.resblocks:
            qkv = blk.attn.in_proj(blk.ln_1(x)).view(b, l, heads, 3 * hd)
            q, k, val = (t.transpose(1, 2) for t in qkv.split(hd, dim=-1))
            x = x + blk.attn.out_proj(attention(q, k, val).transpose(1, 2).reshape(b, l, e))
            x = x + blk.mlp.c_proj(F.gelu(blk.mlp.c_fc(blk.ln_2(x))))
        return self.ln_post(self.attn_pool(x)) @ self.proj


class Agent(nn.Module):
    """The agent's LLM and resamplers under the program's names."""

    def __init__(self, c: dict):
        super().__init__()
        a, d = c["agent"], c["hidden_size"]
        self.c = c
        self.llm = Llama(c)
        self.input_resampler = QwenResampler(a["input_resampler_grid"], d, a["resampler_heads"],
                                             a["vit_dim"])
        self.output_resampler = QwenResampler(a["output_resampler_grid"], a["vit_dim"],
                                              a["resampler_heads"], d)

    def prompt_embeds(self, ids: np.ndarray, cmp: np.ndarray, images: torch.Tensor):
        """Token embeddings (1, P, D) with the resampled image features in the
        comprehension slots, images in order."""
        dev = images.device
        x = self.llm.model.embed_tokens.weight[torch.as_tensor(ids, device=dev)]
        feats = self.input_resampler(images).reshape(-1, x.shape[-1])
        slots = torch.as_tensor(np.flatnonzero(cmp), device=dev)
        x[slots] = feats[:len(slots)]
        return x[None]


LLM_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def is_projection_weight(name: str) -> bool:
    parts = name.split(".")
    return parts[-1] == "weight" and len(parts) >= 2 and parts[-2] in LLM_PROJECTIONS
