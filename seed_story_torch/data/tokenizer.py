"""Tokenizer surface of the port: the LLaMA id layout with the 66 multimodal
tokens; the port's own copy of what it uses of
``seed_story_tpu/data/tokenizer.py``.

Canonical id layout: base LLaMA-2 vocab 32000, then
  32000: <img>    32001: </img>    32002+k: <img_{k:05d}>
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List

BOI_TOKEN = "<img>"
EOI_TOKEN = "</img>"
IMG_TOKEN = "<img_{:05d}>"

LLAMA_VOCAB_SIZE = 32000
NUM_IMG_TOKENS = 64
MULTIMODAL_VOCAB_SIZE = LLAMA_VOCAB_SIZE + 2 + NUM_IMG_TOKENS  # 32066

BOI_TOKEN_ID = 32000
EOI_TOKEN_ID = 32001
FIRST_IMG_TOKEN_ID = 32002


def special_tokens() -> List[str]:
    return [BOI_TOKEN, EOI_TOKEN] + [IMG_TOKEN.format(i) for i in range(NUM_IMG_TOKENS)]


def image_comprehension_string(num_tokens: int = NUM_IMG_TOKENS) -> str:
    """'<img><img_00000>...<img_000NN></img>': the per-image token block."""
    return BOI_TOKEN + "".join(IMG_TOKEN.format(i) for i in range(num_tokens)) + EOI_TOKEN


def load_llama_tokenizer(pretrained_model_name_or_path: str):
    """HF LLaMA tokenizer with the 66 multimodal tokens appended at the
    canonical ids (``configs/tokenizer/clm_llama_tokenizer.yaml``). Needs
    ``transformers``: the fast tokenizer where the directory has a
    ``tokenizer.json``, the sentencepiece one otherwise, and when that one
    raises ``ImportError`` (no sentencepiece library) the pure-Python
    ``data.spm.SentencePieceTokenizer`` on the ``.model`` file."""
    import os

    from transformers import AutoTokenizer, LlamaTokenizer

    path = pretrained_model_name_or_path
    if os.path.isdir(path) and os.path.exists(os.path.join(path, "tokenizer.json")):
        tok = AutoTokenizer.from_pretrained(path, use_fast=True)
    else:
        try:
            tok = LlamaTokenizer.from_pretrained(path)
        except ImportError:
            # the slow tokenizer needs the sentencepiece library; with only
            # the .model asset, the pure-Python data/spm.py reads it
            from .spm import SentencePieceTokenizer

            model_file = os.path.join(path, "tokenizer.model") if os.path.isdir(path) else path
            if not os.path.exists(model_file):
                raise
            tok = SentencePieceTokenizer(model_file)
    if len(tok) < MULTIMODAL_VOCAB_SIZE:
        tok.add_tokens(special_tokens())
    if len(tok) != MULTIMODAL_VOCAB_SIZE:
        raise ValueError(f"tokenizer at {path!r} has {len(tok)} ids, "
                         f"expected {MULTIMODAL_VOCAB_SIZE}")
    bad = [t for i, t in enumerate(special_tokens())
           if tok.convert_tokens_to_ids(t) != LLAMA_VOCAB_SIZE + i]
    if bad:
        raise ValueError(f"tokenizer at {path!r} maps {bad[0]!r} (+{len(bad) - 1} more) "
                         "away from the canonical 32000+ ids. Convert the model with python -m "
                         "seed_story_torch.tools.convert_torch_weights --added_tokens_json "
                         "<released added_tokens.json> to permute rows 32000+ into the canonical "
                         "special_tokens() order, and re-save the tokenizer in canonical order.")
    return tok


def bert_tokenizer(pretrained_model_name_or_path: str):
    """The BERT tokenizer with a '[DEC]' bos that the contrastive discrete
    models' text side uses. Needs ``transformers``."""
    from transformers import BertTokenizer

    tok = BertTokenizer.from_pretrained(pretrained_model_name_or_path=pretrained_model_name_or_path,
                                        truncation_side="right")
    tok.add_special_tokens({"bos_token": "[DEC]"})
    return tok


_WORD_RE = re.compile(r"<img_\d{5}>|</?img>|\[INST\]|\[/INST\]|[A-Za-z0-9']+|[^\sA-Za-z0-9]")


@dataclass
class TinyTokenizer:
    """Deterministic, dependency-free word tokenizer with the LLaMA id
    layout, for tests, pico configs and random-weight runs. Words hash into
    [100, 31999]; specials sit at the canonical multimodal ids; bos=1,
    eos=2, pad=0, unk=3."""

    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0
    unk_token_id: int = 3
    vocab_size: int = MULTIMODAL_VOCAB_SIZE
    _special: dict = field(default_factory=dict)

    def __post_init__(self):
        for i, t in enumerate(special_tokens()):
            self._special[t] = LLAMA_VOCAB_SIZE + i
        self._special["[INST]"] = 29961  # stable ids for the markers
        self._special["[/INST]"] = 29962
        self._inv_special = {v: k for k, v in self._special.items()}

    def _word_id(self, w: str) -> int:
        h = 0
        for ch in w:
            h = (h * 131 + ord(ch)) % (LLAMA_VOCAB_SIZE - 200)
        return 100 + h

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = [self.bos_token_id] if add_special_tokens else []
        for w in _WORD_RE.findall(text):
            ids.append(self._special.get(w, self._word_id(w)))
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out = []
        for i in list(ids):
            i = int(i)
            if i in (self.bos_token_id, self.eos_token_id, self.pad_token_id):
                continue
            if i in self._inv_special:
                if not skip_special_tokens or self._inv_special[i] in ("[INST]", "[/INST]"):
                    out.append(self._inv_special[i])
            else:
                out.append(f"w{i}")
        return " ".join(out)

    def __len__(self):
        return self.vocab_size
