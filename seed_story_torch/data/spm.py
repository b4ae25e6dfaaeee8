"""Pure-Python sentencepiece-compatible tokenizer; the port's own copy of
``seed_story_tpu/data/spm.py`` (the port imports nothing of the JAX
package).

The slow LLaMA tokenizer loads a sentencepiece ``.model`` through HF
``LlamaTokenizer`` (``configs/tokenizer/clm_llama_tokenizer.yaml``), which
needs the sentencepiece C++ library. Where that library is absent,
``data.tokenizer.load_llama_tokenizer`` falls back to this module:

  * a ``ModelProto`` wire-format reader AND writer (tag = field<<3 |
    wiretype; varint / fixed32 / length-delimited); the writer lets tests
    serialize synthetic ``.model`` files;
  * both segmentation algorithms of LLaMA-family assets: **unigram**
    (Viterbi max-log-prob segmentation with the unk penalty, min matchable
    score - 10) and **BPE** (iterative best-scoring adjacent merge,
    leftmost on ties);
  * byte fallback: characters outside the vocab decompose into their UTF-8
    ``<0xXX>`` BYTE pieces, and decode re-assembles byte runs;
  * the normalizer subset these models use: optional NFKC through
    ``unicodedata`` (precompiled charsmaps are approximated),
    ``add_dummy_prefix``, ``remove_extra_whitespaces``,
    ``escape_whitespaces`` (space -> U+2581).

``SentencePieceTokenizer`` has the HF-protocol surface the package uses
(``encode`` / ``decode`` / ``add_tokens`` / ``convert_tokens_to_ids`` /
``__len__``).

Schema (field numbers) per the public sentencepiece_model.proto:
ModelProto{pieces=1, trainer_spec=2, normalizer_spec=3};
SentencePiece{piece=1, score=2, type=3};
TrainerSpec{model_type=3, byte_fallback=35, unk_id=40, bos_id=41,
eos_id=42, pad_id=43}; NormalizerSpec{name=1, add_dummy_prefix=3,
remove_extra_whitespaces=4, escape_whitespaces=5}.
"""

from __future__ import annotations

import re
import struct
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

WHITESPACE_PIECE = "▁"  # ▁

# SentencePiece.Type enum
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6

# TrainerSpec.ModelType enum
UNIGRAM = 1
BPE = 2

_UNK_PENALTY = 10.0  # sentencepiece kUnkPenalty (unigram_model.cc)


# ---------------------------------------------------------------------------
# protobuf wire format (reader)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _signed(v: int) -> int:
    """proto2 int32/int64 negatives arrive as 64-bit two's complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _iter_fields(buf: bytes):
    """Yields (field_number, wire_type, value) over one message's bytes.

    wire types: 0 varint (int), 1 fixed64 (bytes), 2 length-delimited
    (bytes), 5 fixed32 (bytes). Groups (3/4) are obsolete and rejected.
    """
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v, i = buf[i : i + 8], i + 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i : i + ln], i + ln
        elif wt == 5:
            v, i = buf[i : i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield fno, wt, v


# ---------------------------------------------------------------------------
# protobuf wire format (writer — synthetic .model fixtures)
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64  # two's complement, 10-byte encoding
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(fno: int, v: int) -> bytes:
    return _varint(fno << 3 | 0) + _varint(v)


def _field_bytes(fno: int, v: bytes) -> bytes:
    return _varint(fno << 3 | 2) + _varint(len(v)) + v


def _field_float(fno: int, v: float) -> bytes:
    return _varint(fno << 3 | 5) + struct.pack("<f", v)


def build_sentencepiece_model(
    pieces: Sequence[Tuple[str, float, int]],
    *,
    model_type: int = UNIGRAM,
    byte_fallback: bool = False,
    unk_id: int = 0,
    bos_id: int = 1,
    eos_id: int = 2,
    pad_id: int = -1,
    normalizer_name: str = "identity",
    add_dummy_prefix: bool = True,
    remove_extra_whitespaces: bool = True,
    escape_whitespaces: bool = True,
) -> bytes:
    """Serialize a ModelProto; ``pieces`` is [(surface, score, type), ...].

    Used by tests (synthetic fixtures) and by tools that need to mint a
    tokenizer asset in an environment without sentencepiece.
    """
    out = bytearray()
    for piece, score, typ in pieces:
        sp = (
            _field_bytes(1, piece.encode("utf-8"))
            + _field_float(2, float(score))
            + _field_varint(3, typ)
        )
        out += _field_bytes(1, sp)
    trainer = (
        _field_varint(3, model_type)
        + _field_varint(35, int(byte_fallback))
        + _field_varint(40, unk_id)
        + _field_varint(41, bos_id)
        + _field_varint(42, eos_id)
        + _field_varint(43, pad_id)
    )
    out += _field_bytes(2, trainer)
    norm = (
        _field_bytes(1, normalizer_name.encode("utf-8"))
        + _field_varint(3, int(add_dummy_prefix))
        + _field_varint(4, int(remove_extra_whitespaces))
        + _field_varint(5, int(escape_whitespaces))
    )
    out += _field_bytes(3, norm)
    return bytes(out)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


@dataclass
class SentencePieceModel:
    pieces: List[Tuple[str, float, int]] = field(default_factory=list)
    model_type: int = UNIGRAM
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    normalizer_name: str = "identity"
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True

    @classmethod
    def parse(cls, blob: bytes) -> "SentencePieceModel":
        m = cls()
        for fno, wt, v in _iter_fields(blob):
            if fno == 1 and wt == 2:  # SentencePiece
                piece, score, typ = "", 0.0, NORMAL
                for f2, w2, v2 in _iter_fields(v):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        typ = v2
                m.pieces.append((piece, score, typ))
            elif fno == 2 and wt == 2:  # TrainerSpec
                for f2, w2, v2 in _iter_fields(v):
                    if f2 == 3:
                        m.model_type = v2
                    elif f2 == 35:
                        m.byte_fallback = bool(v2)
                    elif f2 == 40:
                        m.unk_id = _signed(v2)
                    elif f2 == 41:
                        m.bos_id = _signed(v2)
                    elif f2 == 42:
                        m.eos_id = _signed(v2)
                    elif f2 == 43:
                        m.pad_id = _signed(v2)
            elif fno == 3 and wt == 2:  # NormalizerSpec
                for f2, w2, v2 in _iter_fields(v):
                    if f2 == 1:
                        m.normalizer_name = v2.decode("utf-8")
                    elif f2 == 3:
                        m.add_dummy_prefix = bool(v2)
                    elif f2 == 4:
                        m.remove_extra_whitespaces = bool(v2)
                    elif f2 == 5:
                        m.escape_whitespaces = bool(v2)
        return m


class SentencePieceProcessor:
    """Encode/decode against a parsed ``SentencePieceModel``.

    Matches sentencepiece semantics for the feature subset LLaMA-family
    models exercise; CONTROL/UNKNOWN/UNUSED/BYTE pieces never match raw
    text (only NORMAL and USER_DEFINED enter the match table, as in the
    sentencepiece trie).
    """

    def __init__(self, model: SentencePieceModel):
        self.m = model
        self._match: Dict[str, Tuple[int, float]] = {}
        self._byte_id: Dict[int, int] = {}
        matchable_scores = []
        for i, (piece, score, typ) in enumerate(model.pieces):
            if typ in (NORMAL, USER_DEFINED):
                self._match.setdefault(piece, (i, score))
                matchable_scores.append(score)
            elif typ == BYTE:
                try:
                    self._byte_id[int(piece[1:-1], 16)] = i  # "<0xAB>"
                except ValueError:
                    pass
        self._max_piece_len = max(
            (len(p) for p, _, t in model.pieces if t in (NORMAL, USER_DEFINED)),
            default=1,
        )
        self._unk_score = (
            min(matchable_scores) if matchable_scores else 0.0
        ) - _UNK_PENALTY

    # -- normalization ----------------------------------------------------

    def normalize(self, text: str) -> str:
        m = self.m
        if "nfkc" in m.normalizer_name.lower():
            # precompiled charsmap approximated by unicodedata NFKC
            text = unicodedata.normalize("NFKC", text)
        if m.remove_extra_whitespaces:
            text = re.sub(r" +", " ", text).strip(" ")
        if m.add_dummy_prefix and text:
            text = " " + text
        if m.escape_whitespaces:
            text = text.replace(" ", WHITESPACE_PIECE)
        return text

    # -- encode -----------------------------------------------------------

    def _char_fallback(self, ch: str) -> List[int]:
        if self.m.byte_fallback and self._byte_id:
            ids = [self._byte_id.get(b) for b in ch.encode("utf-8")]
            if all(i is not None for i in ids):
                return ids  # type: ignore[return-value]
        return [self.m.unk_id]

    def _encode_unigram(self, s: str) -> List[int]:
        n = len(s)
        neg = float("-inf")
        best = [neg] * (n + 1)
        best[0] = 0.0
        back: List[Optional[Tuple[int, Optional[int]]]] = [None] * (n + 1)
        for i in range(n):
            if best[i] == neg:
                continue
            # unk transition: one char at the penalty score
            sc = best[i] + self._unk_score
            if sc > best[i + 1]:
                best[i + 1] = sc
                back[i + 1] = (i, None)
            top = min(self._max_piece_len, n - i)
            for ln in range(1, top + 1):
                hit = self._match.get(s[i : i + ln])
                if hit is None:
                    continue
                sc = best[i] + hit[1]
                if sc > best[i + ln]:
                    best[i + ln] = sc
                    back[i + ln] = (i, hit[0])
        out: List[int] = []
        j = n
        while j > 0:
            i, pid = back[j]  # type: ignore[misc]
            if pid is None:
                out.extend(reversed(self._char_fallback(s[i:j])))
            else:
                out.append(pid)
            j = i
        out.reverse()
        return out

    def _encode_bpe(self, s: str) -> List[int]:
        syms = list(s)
        while len(syms) > 1:
            best_score, best_i = None, -1
            for i in range(len(syms) - 1):
                hit = self._match.get(syms[i] + syms[i + 1])
                if hit is not None and (
                    best_score is None or hit[1] > best_score
                ):
                    best_score, best_i = hit[1], i
            if best_i < 0:
                break
            syms[best_i : best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        out: List[int] = []
        for sym in syms:
            hit = self._match.get(sym)
            if hit is not None:
                out.append(hit[0])
            else:
                # unmerged symbols are single chars by construction
                out.extend(self._char_fallback(sym))
        return out

    def encode(self, text: str) -> List[int]:
        s = self.normalize(text)
        if not s:
            return []
        if self.m.model_type == BPE:
            return self._encode_bpe(s)
        return self._encode_unigram(s)

    # -- decode -----------------------------------------------------------

    def decode(self, ids: Sequence[int], skip_special: bool = False) -> str:
        parts: List[str] = []
        byte_buf = bytearray()
        # the dummy prefix lives on the FIRST content piece's leading ▁
        # (control pieces around it don't carry it) — strip it there
        strip_next = [self.m.add_dummy_prefix]

        def emit(s: str):
            if strip_next[0]:
                strip_next[0] = False
                if s.startswith(" "):
                    s = s[1:]
            parts.append(s)

        def flush():
            if byte_buf:
                emit(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.m.pieces):
                continue
            piece, _, typ = self.m.pieces[i]
            if typ == BYTE:
                try:
                    byte_buf.append(int(piece[1:-1], 16))
                    continue
                except ValueError:
                    pass
            flush()
            if typ == CONTROL:
                if not skip_special:
                    parts.append(piece)
            elif typ == UNKNOWN:
                if not skip_special:
                    emit(" ⁇ ")  # sp renders unk as ' ⁇ '
            else:
                emit(piece.replace(WHITESPACE_PIECE, " "))
        flush()
        return "".join(parts)


class SentencePieceTokenizer:
    """HF-protocol wrapper: the slow-path ``load_llama_tokenizer`` stand-in.

    Added tokens (the 66 multimodal specials) are matched greedily BEFORE
    segmentation and take ids ``n_pieces + k`` in insertion order —
    exactly the HF slow-tokenizer layout the reference asset uses
    (reference configs/tokenizer/clm_llama_tokenizer.yaml).
    """

    def __init__(self, model_path: str):
        with open(model_path, "rb") as f:
            self.model = SentencePieceModel.parse(f.read())
        self.sp = SentencePieceProcessor(self.model)
        self._added: Dict[str, int] = {}
        self._added_inv: Dict[int, str] = {}
        self._added_re: Optional[re.Pattern] = None
        m = self.model
        self.bos_token_id = m.bos_id if m.bos_id >= 0 else None
        self.eos_token_id = m.eos_id if m.eos_id >= 0 else None
        self.pad_token_id = m.pad_id if m.pad_id >= 0 else None
        self.unk_token_id = m.unk_id if m.unk_id >= 0 else None

    # -- vocab surface ------------------------------------------------------

    def __len__(self) -> int:
        return len(self.model.pieces) + len(self._added)

    @property
    def vocab_size(self) -> int:
        return len(self.model.pieces)

    def add_tokens(self, tokens: Sequence[str]) -> int:
        added = 0
        for t in tokens:
            if t in self._added or t in self.sp._match:
                continue
            tid = len(self.model.pieces) + len(self._added)
            self._added[t] = tid
            self._added_inv[tid] = t
            added += 1
        if self._added:
            self._added_re = re.compile(
                "|".join(
                    re.escape(t)
                    for t in sorted(self._added, key=len, reverse=True)
                )
            )
        return added

    def convert_tokens_to_ids(self, token):
        if isinstance(token, (list, tuple)):
            return [self.convert_tokens_to_ids(t) for t in token]
        if token in self._added:
            return self._added[token]
        hit = self.sp._match.get(token)
        if hit is not None:
            return hit[0]
        # control pieces (<s>, </s>, <unk>, ...) resolve by surface too
        for i, (piece, _, _) in enumerate(self.model.pieces):
            if piece == token:
                return i
        return self.model.unk_id

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, int):
            ids = [ids]
            single = True
        else:
            single = False
        out = []
        for i in ids:
            i = int(i)
            if i in self._added_inv:
                out.append(self._added_inv[i])
            elif 0 <= i < len(self.model.pieces):
                out.append(self.model.pieces[i][0])
            else:
                out.append(self.model.pieces[self.model.unk_id][0])
        return out[0] if single else out

    # -- encode/decode ------------------------------------------------------

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        if add_special_tokens and self.bos_token_id is not None:
            ids.append(self.bos_token_id)  # LLaMA: bos only, no eos
        if self._added_re is None:
            ids.extend(self.sp.encode(text))
            return ids
        pos = 0
        for mt in self._added_re.finditer(text):
            if mt.start() > pos:
                ids.extend(self.sp.encode(text[pos : mt.start()]))
            ids.append(self._added[mt.group()])
            pos = mt.end()
        if pos < len(text):
            ids.extend(self.sp.encode(text[pos:]))
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        parts: List[str] = []
        run: List[int] = []

        def flush():
            if run:
                parts.append(self.sp.decode(run, skip_special=skip_special_tokens))
                run.clear()

        for i in list(ids):
            i = int(i)
            if i in self._added_inv:
                flush()
                # added tokens are never "special" in the HF sense here
                # (they were registered via add_tokens, not as specials)
                parts.append(self._added_inv[i])
            else:
                run.append(i)
        flush()
        return "".join(parts)
