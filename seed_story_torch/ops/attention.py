"""Multi-head attention: the mask contract of
``seed_story_tpu/ops/attention.py``, a plain PyTorch version, and the
hand-written CUDA flash forward (``csrc/flash_fwd.cu``) behind one entry.

Masking rule for query row ``i`` (0-based within the call) and key ``j``:

  visible(b, i, j) = (j < kv_len[b]) and (not causal or j <= q_start[b] + i)

Defaults ``q_start = Skv - Sq`` and ``kv_len = Skv``. Rows with no visible
key output exactly 0 (LSE -inf).

``mha(implementation="auto")`` runs the plain version on CPU tensors and the
kernel on CUDA tensors. There is no fallback: a CUDA tensor the kernel does
not take raises, and so does a failed build or launch.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from .cuda_lib import BuiltLibrary

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

Lens = Union[None, int, torch.Tensor]


def _normalize_lens(b: int, sq: int, skv: int, q_start: Lens, kv_len: Lens,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    def as_rows(x, default):
        if x is None:
            x = default
        return torch.as_tensor(x, dtype=torch.int32, device=device).expand(b).contiguous()

    return as_rows(q_start, skv - sq), as_rows(kv_len, skv)


def _visible(sq: int, skv: int, causal: bool, q_start: torch.Tensor,
             kv_len: torch.Tensor) -> torch.Tensor:
    """(B, 1, Sq, Skv) bool mask of the contract above."""
    jpos = torch.arange(skv, device=kv_len.device)[None, None, None, :]
    mask = jpos < kv_len[:, None, None, None]
    if causal:
        ipos = torch.arange(sq, device=kv_len.device)[None, None, :, None]
        mask = mask & (jpos <= q_start[:, None, None, None] + ipos)
    return mask


def mha_reference_lse(q, k, v, *, causal: bool = True, q_start: Lens = None,
                      kv_len: Lens = None, scale: Optional[float] = None):
    """Plain O(S^2)-memory attention in f32, returning (O in q.dtype, LSE f32
    of shape (B, Hq, Sq, 1)). q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q_start, kv_len = _normalize_lens(b, sq, skv, q_start, kv_len, q.device)

    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    mask = _visible(sq, skv, causal, q_start, kv_len)
    logits = torch.where(mask, qf @ kf.transpose(-1, -2), DEFAULT_MASK_VALUE)
    any_visible = mask.any(dim=-1, keepdim=True)
    probs = torch.where(any_visible, torch.softmax(logits, dim=-1), 0.0)
    out = (probs @ vf).to(q.dtype)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    lse = torch.where(any_visible, lse, float("-inf"))
    return out, lse


def mha_reference(q, k, v, *, causal: bool = True, q_start: Lens = None,
                  kv_len: Lens = None, scale: Optional[float] = None):
    """Plain attention output alone (counterpart of the JAX ``mha_reference``)."""
    return mha_reference_lse(q, k, v, causal=causal, q_start=q_start,
                             kv_len=kv_len, scale=scale)[0]


def decode_attention(q, k, v, *, kv_len: torch.Tensor,
                     q_start: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None):
    """Small-query attention for the decode path (plain PyTorch; XLA in the
    JAX package). GQA folds the group into the query rows, the scores are
    f32, and the probabilities are cast to the value dtype for the PV
    product with f32 accumulation, as the JAX version does.

    q: (B, Hq, S, D) with small S; k/v: (B, Hkv, C, D); kv_len: (B,) valid
    prefix. For S > 1, ``q_start`` (B,) is the cache position of query 0.
    Returns (B, Hq, S, D).
    """
    b, hq, sq, d = q.shape
    _, hkv, c, _ = k.shape
    if sq > 1 and q_start is None:
        raise ValueError("q_start is required for multi-query decode attention")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, group * sq, d)
    logits = (qg.float() @ k.float().transpose(-1, -2)) * scale  # (B, Hkv, G*S, C)
    pos = torch.arange(c, device=q.device)[None, None, None, :]
    if sq == 1:
        mask = pos < kv_len[:, None, None, None]
    else:
        limit = q_start[:, None] + torch.arange(sq, device=q.device)[None, :] + 1
        limit = torch.minimum(limit, kv_len[:, None]).repeat(1, group)  # rows g-major
        mask = pos < limit[:, None, :, None]
    logits = torch.where(mask, logits, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    out = probs.to(q.dtype) @ v.to(q.dtype)
    return out.reshape(b, hq, sq, d)


class FlashForward:
    """Wrapper of the CUDA flash forward. ``launches`` counts kernel launches
    made through it; nothing else touches the count."""

    def __init__(self):
        self.launches = 0
        self._built: Optional[BuiltLibrary] = None

    def build(self) -> BuiltLibrary:
        if self._built is None:
            built = BuiltLibrary("flash_fwd")
            fn = built.lib.flash_fwd_bf16
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 9
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._built = built
        return self._built

    def __call__(self, q, k, v, q_start: torch.Tensor, kv_len: torch.Tensor,
                 causal: bool, scale: float):
        """q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D) bf16 CUDA tensors with a
        unit-stride head dim (other strides are free); q_start, kv_len: (B,)
        int32 on the same device. Returns O (B, Hq, Sq, D) bf16 and LSE
        (B, Hq, Sq, 1) f32."""
        b, hq, sq, d = q.shape
        _, hkv, skv, _ = k.shape
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_cuda or t.device != q.device:
                raise ValueError(f"flash_fwd: {name} must be on {q.device}, got {t.device}")
            if t.dtype != torch.bfloat16:
                raise TypeError(f"flash_fwd takes bfloat16, got {name}.dtype={t.dtype}")
            if t.stride(-1) != 1:
                raise ValueError(f"flash_fwd: {name} needs a unit-stride head dim")
        if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hq % hkv:
            raise ValueError(f"flash_fwd: bad shapes q={tuple(q.shape)} "
                             f"k={tuple(k.shape)} v={tuple(v.shape)}")
        if not 0 < d <= 128:
            raise ValueError(f"flash_fwd takes head dims 1..128, got {d}")
        for name, t in (("q_start", q_start), ("kv_len", kv_len)):
            if (t.dtype != torch.int32 or t.device != q.device or t.shape != (b,)
                    or not t.is_contiguous()):
                raise ValueError(f"flash_fwd: {name} must be contiguous int32 ({b},) "
                                 f"on {q.device}")
        o = torch.empty((b, hq, sq, d), dtype=torch.bfloat16, device=q.device)
        lse = torch.empty((b, hq, sq, 1), dtype=torch.float32, device=q.device)
        if b == 0 or hq == 0 or sq == 0:
            return o, lse
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        vec = all(t.data_ptr() % 16 == 0 for t in (q, k, v)) and all(
            s % 8 == 0 for s in strides)
        fn = self.build().lib.flash_fwd_bf16
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), q_start.data_ptr(), kv_len.data_ptr(),
                     b, hq, hkv, sq, skv, d, *strides, float(scale),
                     int(causal), int(vec), stream)
        if err != 0:
            raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
        self.launches += 1
        return o, lse


flash_fwd = FlashForward()


def mha(q, k, v, *, causal: bool = True, q_start: Lens = None,
        kv_len: Lens = None, scale: Optional[float] = None,
        implementation: str = "auto", with_lse: bool = False):
    """Multi-head attention under the module's mask rule.

    implementation: 'auto' (the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors), 'kernel' (CUDA tensors only) or 'plain'.
    Returns O, or (O, LSE) with ``with_lse``.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv != 0:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if implementation == "auto":
        implementation = "kernel" if q.is_cuda else "plain"
    if implementation == "plain":
        out = mha_reference_lse(q, k, v, causal=causal, q_start=q_start,
                                kv_len=kv_len, scale=scale)
    elif implementation == "kernel":
        if not q.is_cuda:
            raise ValueError("implementation='kernel' needs CUDA tensors")
        qs, kl = _normalize_lens(b, sq, skv, q_start, kv_len, q.device)
        out = flash_fwd(q, k, v, qs, kl, causal, scale)
    else:
        raise ValueError(f"unknown implementation {implementation!r}")
    return out if with_lse else out[0]
