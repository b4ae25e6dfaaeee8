"""Multi-head attention: the mask contract of
``seed_story_tpu/ops/attention.py``, a plain PyTorch version of the forward
and the backward, and the hand-written CUDA flash forward and backward for Hopper
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``: wgmma, TMA, mbarriers)
behind one differentiable entry; and the small-query attention of the
decode path over a bf16 or int8 KV cache (``decode_attention``: a plain
version and the CUDA kernel ``csrc/decode_attn.cu``).

Masking rule for query row ``i`` (0-based within the call) and key ``j``:

  visible(b, i, j) = (j < kv_len[b]) and (not causal or j <= q_start[b] + i)

Defaults ``q_start = Skv - Sq`` and ``kv_len = Skv``. Rows with no visible
key output exactly 0 (LSE -inf).

``mha(implementation="auto")`` runs the plain versions on CPU tensors and
the kernels on CUDA tensors. There is no fallback: a CUDA tensor the
kernels do not take raises, and so does a failed build or launch.
"""

from __future__ import annotations

import ctypes
import math
import numbers
import threading
from typing import Optional, Tuple, Union

import torch

from .cuda_lib import BuiltLibrary, check_launch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

Lens = Union[None, int, torch.Tensor]


def _normalize_lens(b: int, sq: int, skv: int, q_start: Lens, kv_len: Lens,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    def as_rows(x, default):
        if x is None:
            x = default
        if isinstance(x, numbers.Integral):
            # filled on the device: a copy from pageable host memory would
            # wait for the stream, once per attention call
            return torch.full((b,), int(x), dtype=torch.int32, device=device)
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


def decode_attention_reference(q, k, v, *, kv_len: torch.Tensor,
                               q_start: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None):
    """The plain version of :func:`decode_attention`, the JAX formula in
    PyTorch: an int8 cache is converted to the query dtype (the JAX
    ``astype``); the scores ``q K^T`` are f32 products of those values (the
    JAX ``preferred_element_type=float32``: a product of two bf16 values is
    exact in f32); the softmax is f32; the int8 scales multiply the (C,)
    score and probability vectors after the products; the probabilities are
    cast to the query dtype for PV, a product in the query dtype with one
    rounding of its result. On f32 inputs (the CPU tests, the smoke's
    reference) every product is exact f32."""
    b, hq, sq, d = q.shape
    _, hkv, c, _ = k.shape
    if sq > 1 and q_start is None:
        raise ValueError("q_start is required for multi-query decode attention")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, group * sq, d)
    kd = k if k.dtype == q.dtype else k.to(q.dtype)
    logits = (qg.float() @ kd.float().transpose(-1, -2)) * scale  # (B, Hkv, G*S, C), f32
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :].float()
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
    if v_scale is not None:
        probs = probs * v_scale[:, :, None, :].float()
    vd = v if v.dtype == q.dtype else v.to(q.dtype)
    out = probs.to(q.dtype) @ vd
    return out.reshape(b, hq, sq, d)


def _aligned_16(t: torch.Tensor) -> bool:
    """A 16-byte aligned base and (batch, head, position) strides of whole
    16-byte units (dims of size 1 excepted)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or (st * size) % 16 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]))


class DecodeAttention:
    """Wrapper of the CUDA small-query cache attention
    (``csrc/decode_attn.cu``: split-KV on tensor cores, the chunks of a head
    merged inside their thread block cluster). ``launches`` counts the calls
    that launched it (one a call, under a lock); nothing else touches the
    count."""

    ROW_TILE = 16    # query rows (group x S) of a block
    MAX_CHUNKS = 16  # the blocks of a cluster (Hopper's non-portable limit)
    BLOCKS_PER_SM = 2

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._built: Optional[BuiltLibrary] = None
        self._sms = {}

    def build(self) -> BuiltLibrary:
        if self._built is None:
            built = BuiltLibrary("decode_attn")
            fn = built.lib.decode_attn
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                           + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._built = built
        return self._built

    def chunking(self, device, b: int, hkv: int, c: int, row_tiles: int = 1) -> Tuple[int, int]:
        """(keys per chunk, chunks): about two blocks per multiprocessor and
        at most 16 chunks, a chunk a multiple of 64 keys (16 for each of a
        block's 4 warps)."""
        if device not in self._sms:
            self._sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
        want = min(self.MAX_CHUNKS, max(1, -(-self.BLOCKS_PER_SM * self._sms[device]
                                             // (b * hkv * row_tiles))))
        per_chunk = -(-c // want)
        chunk = max(64, (per_chunk + 63) // 64 * 64)
        return chunk, -(-c // chunk)

    def __call__(self, q, k, v, kv_len: torch.Tensor, q_start: Optional[torch.Tensor],
                 scale: float, k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None):
        """q (B, Hq, S, 128) bf16 with S <= 8; k, v (B, Hkv, C, 128), both
        int8 with f32 (B, Hkv, C) scales or both bf16 without, with equal
        strides, a unit-stride head dim and 16-byte aligned rows; kv_len and
        (for S > 1) q_start (B,) int32; all on one CUDA device. Returns
        (B, Hq, S, 128) bf16."""
        b, hq, sq, d = q.shape
        _, hkv, c, _ = k.shape
        if not (q.is_cuda and k.device == q.device and v.device == q.device):
            raise ValueError(f"decode_attn: q, k, v must be on one CUDA device, got "
                             f"{q.device}, {k.device}, {v.device}")
        if q.dtype != torch.bfloat16:
            raise TypeError(f"decode_attn takes a bfloat16 q, got {q.dtype}")
        if k.dtype != v.dtype or k.dtype not in (torch.int8, torch.bfloat16):
            raise TypeError(f"decode_attn takes int8 or bfloat16 K/V, got {k.dtype}/{v.dtype}")
        if d != 128 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hq % hkv:
            raise ValueError(f"decode_attn takes d = 128 and matching shapes, got "
                             f"q={tuple(q.shape)} k={tuple(k.shape)} v={tuple(v.shape)}")
        if not 1 <= sq <= 8:
            raise ValueError(f"decode_attn takes 1..8 queries, got {sq}")
        if (k.stride() != v.stride() or k.stride(-1) != 1 or q.stride(-1) != 1
                or not _aligned_16(k) or not _aligned_16(v)):
            raise ValueError("decode_attn: k and v need equal strides, a unit-stride head "
                             "dim and 16-byte aligned rows")
        quantized = k.dtype == torch.int8
        if quantized != (k_scale is not None and v_scale is not None) or (
                not quantized and (k_scale is not None or v_scale is not None)):
            raise ValueError("decode_attn: an int8 cache needs k_scale and v_scale, a bf16 "
                             "cache takes neither")
        if quantized:
            for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
                if (t.dtype != torch.float32 or t.shape != (b, hkv, c) or t.device != q.device
                        or t.stride() != k_scale.stride()):
                    raise ValueError(f"decode_attn: {name} must be f32 {(b, hkv, c)} on "
                                     f"{q.device} with k_scale's strides")
        if q_start is None:
            if sq > 1:
                raise ValueError("q_start is required for multi-query decode attention")
            q_start = kv_len
        for name, t in (("kv_len", kv_len), ("q_start", q_start)):
            if (t.dtype != torch.int32 or t.device != q.device or t.shape != (b,)
                    or not t.is_contiguous()):
                raise ValueError(f"decode_attn: {name} must be contiguous int32 ({b},) "
                                 f"on {q.device}")
        out = torch.empty((b, hq, sq, d), dtype=torch.bfloat16, device=q.device)
        if b == 0 or hq == 0:
            return out
        if c == 0:
            return out.zero_()
        rows = (hq // hkv) * sq
        chunk, n_chunks = self.chunking(q.device, b, hkv, c, -(-rows // self.ROW_TILE))
        ks_strides = list(k_scale.stride()) if quantized else [0, 0, 0]
        fn = self.build().lib.decode_attn
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     k_scale.data_ptr() if quantized else None,
                     v_scale.data_ptr() if quantized else None,
                     q_start.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                     b, hq, hkv, sq, c, chunk, n_chunks, int(quantized),
                     *q.stride()[:3], *k.stride()[:3], *ks_strides, float(scale), stream)
        check_launch("decode_attn", err)
        with self._lock:
            self.launches += 1
        return out


decode_attn = DecodeAttention()


def decode_attention(q, k, v, *, kv_len: torch.Tensor,
                     q_start: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     implementation: str = "auto"):
    """Small-query attention for the decode path (single-token decode and
    short speculative-verify blocks); the counterpart of the JAX
    ``decode_attention`` (XLA there). GQA folds the group into the query
    rows; with an int8 cache, ``k_scale`` / ``v_scale`` (B, Hkv, C) apply to
    the score and probability vectors after the products, so no dequantized
    copy of the cache exists.

    q: (B, Hq, S, D) with small S; k/v: (B, Hkv, C, D); kv_len: (B,) valid
    prefix. For S > 1, ``q_start`` (B,) is the cache position of query 0:
    query i sees keys < min(q_start + i + 1, kv_len). Returns (B, Hq, S, D).

    implementation: 'auto' (the plain version for CPU tensors, the CUDA
    kernel ``csrc/decode_attn.cu`` for CUDA tensors), 'kernel' or 'plain'.
    """
    if implementation == "auto":
        implementation = "kernel" if q.is_cuda else "plain"
    if implementation == "plain":
        return decode_attention_reference(q, k, v, kv_len=kv_len, q_start=q_start, scale=scale,
                                          k_scale=k_scale, v_scale=v_scale)
    if implementation != "kernel":
        raise ValueError(f"unknown implementation {implementation!r}")
    if not q.is_cuda:
        raise ValueError("implementation='kernel' needs CUDA tensors")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return decode_attn(q, k, v, kv_len, q_start, scale, k_scale, v_scale)


def mha_backward_reference(q, k, v, o, lse, do, *, causal: bool = True, q_start: Lens = None,
                           kv_len: Lens = None, scale: Optional[float] = None):
    """Plain attention backward in f32 under the module's mask rule: the
    formulas of the flash backward (P = exp(scale * Q K^T - LSE) on visible
    entries, dS = P * (dO V^T - rowsum(dO * O)), dq = scale * dS K,
    dk = scale * dS^T Q, dv = P^T dO), with the GQA group summed. Rows with
    no visible key give zero gradient. Returns (dq, dk, dv) in the dtypes of
    q, k and v."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q_start, kv_len = _normalize_lens(b, sq, skv, q_start, kv_len, q.device)
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    if group > 1:
        kf = kf.repeat_interleave(group, dim=1)
        vf = vf.repeat_interleave(group, dim=1)
    mask = _visible(sq, skv, causal, q_start, kv_len)
    scores = scale * (qf @ kf.transpose(-1, -2))
    # a select, not a product with the mask: exp is inf on rows whose LSE is -inf
    probs = torch.where(mask, torch.exp(scores - lse), 0.0)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = probs * (dof @ vf.transpose(-1, -2) - delta)
    dq = scale * (ds @ kf)
    dk = scale * (ds.transpose(-1, -2) @ qf)
    dv = probs.transpose(-1, -2) @ dof
    if group > 1:
        dk = dk.view(b, hkv, group, skv, d).sum(dim=2)
        dv = dv.view(b, hkv, group, skv, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_inputs(kernel: str, q, k, v, q_start, kv_len, **more):
    """Raises on what the flash kernels do not take: bf16 CUDA tensors on one
    device with a unit-stride head dim, d <= 128, int32 (B,) lengths."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{kernel}: {name} must be on {q.device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} takes bfloat16, got {name}.dtype={t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{kernel}: {name} needs a unit-stride head dim")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"{kernel}: bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if not 0 < d <= 128:
        raise ValueError(f"{kernel} takes head dims 1..128, got {d}")
    for name, t in (("q_start", q_start), ("kv_len", kv_len)):
        if (t.dtype != torch.int32 or t.device != q.device or t.shape != (b,)
                or not t.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be contiguous int32 ({b},) "
                             f"on {q.device}")


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA reads ``t`` (B, H, S, D) in place: a 16-byte aligned base
    and (batch, head, seq) strides of whole 16-byte units, non-zero on every
    dim longer than 1."""
    return t.data_ptr() % 16 == 0 and all(
        size == 1 or (stride > 0 and stride % 8 == 0)
        for size, stride in zip(t.shape[:3], t.stride()[:3]))


def padded_copy(t: torch.Tensor, cols: int) -> torch.Tensor:
    """A contiguous copy of ``t`` (B, H, S, D) with D zero-padded to ``cols``."""
    out = t.new_zeros((*t.shape[:3], cols))
    out[..., :t.shape[3]] = t
    return out


class FlashForward:
    """Wrapper of the CUDA flash forward. ``launches`` counts kernel launches
    made through it; nothing else touches the count. ``padded_copies``
    counts the inputs it copied first because TMA cannot read them in place
    (see :func:`tma_ready`). Both counts move under a lock: a de-tokenizer
    thread may launch the kernel beside the decode loop."""

    def __init__(self):
        self.launches = 0
        self.padded_copies = 0
        self._lock = threading.Lock()
        self._built: Optional[BuiltLibrary] = None

    def build(self) -> BuiltLibrary:
        if self._built is None:
            built = BuiltLibrary("flash_fwd")
            fn = built.lib.flash_fwd_bf16
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                           + [ctypes.c_longlong] * 9
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._built = built
        return self._built

    def __call__(self, q, k, v, q_start: torch.Tensor, kv_len: torch.Tensor,
                 causal: bool, scale: float):
        """q: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D) bf16 CUDA tensors with a
        unit-stride head dim (other strides are free); q_start, kv_len: (B,)
        int32 on the same device; scale > 0. Returns O (B, Hq, Sq, D) bf16 and
        LSE (B, Hq, Sq, 1) f32. Inputs that TMA cannot read in place are
        copied into aligned buffers with D padded to a multiple of 8, and the
        same kernel runs on those."""
        _check_kernel_inputs("flash_fwd", q, k, v, q_start, kv_len)
        if not scale > 0:
            raise ValueError(f"flash_fwd takes a positive scale, got {scale}")
        b, hq, sq, d = q.shape
        _, hkv, skv, _ = k.shape
        o = torch.empty((b, hq, sq, d), dtype=torch.bfloat16, device=q.device)
        lse = torch.empty((b, hq, sq, 1), dtype=torch.float32, device=q.device)
        if b == 0 or hq == 0 or sq == 0:
            return o, lse
        if skv == 0:  # no key at all: every row is empty
            return o.zero_(), lse.fill_(float("-inf"))
        d_in = d
        if not all(tma_ready(t) for t in (q, k, v)):
            d_in = -(-d // 8) * 8
            q, k, v = (padded_copy(t, d_in) for t in (q, k, v))
            with self._lock:
                self.padded_copies += 3
        strides = [s for t in (q, k, v) for s in t.stride()[:3]]
        fn = self.build().lib.flash_fwd_bf16
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     lse.data_ptr(), q_start.data_ptr(), kv_len.data_ptr(),
                     b, hq, hkv, sq, skv, d, d_in, *strides, float(scale),
                     int(causal), stream)
        check_launch("flash_fwd", err)
        with self._lock:
            self.launches += 1
        return o, lse


class FlashBackward:
    """Wrapper of the two CUDA flash backward kernels (``csrc/flash_bwd.cu``).
    ``dq_launches`` and ``dkv_launches`` count the launches of each, made
    through it; nothing else touches the counts. ``padded_copies`` counts
    the inputs it copied first because TMA cannot read them in place (see
    :func:`tma_ready`)."""

    def __init__(self):
        self.dq_launches = 0
        self.dkv_launches = 0
        self.padded_copies = 0
        self._built: Optional[BuiltLibrary] = None

    def build(self) -> BuiltLibrary:
        if self._built is None:
            built = BuiltLibrary("flash_bwd")
            for fn in (built.lib.flash_bwd_dq_bf16, built.lib.flash_bwd_dkv_bf16):
                fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                               + [ctypes.c_longlong] * 15
                               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
                fn.restype = ctypes.c_int
            self._built = built
        return self._built

    def __call__(self, q, k, v, o, lse, do, q_start: torch.Tensor, kv_len: torch.Tensor,
                 causal: bool, scale: float):
        """q, o, do: (B, Hq, Sq, D), k/v: (B, Hkv, Skv, D) bf16 CUDA tensors
        with a unit-stride head dim (other strides are free); lse: the
        forward's (B, Hq, Sq, 1) f32; q_start, kv_len: (B,) int32. Returns dq,
        dk, dv (bf16, contiguous). delta = rowsum(dO * O) is computed in f32
        by the dq kernel, which writes it for the dk/dv kernel. Inputs that
        TMA cannot read in place are copied as in :class:`FlashForward`."""
        _check_kernel_inputs("flash_bwd", q, k, v, q_start, kv_len, o=o, do=do)
        if not scale > 0:
            raise ValueError(f"flash_bwd takes a positive scale, got {scale}")
        b, hq, sq, d = q.shape
        _, hkv, skv, _ = k.shape
        if o.shape != q.shape or do.shape != q.shape:
            raise ValueError(f"flash_bwd: o {tuple(o.shape)} and do {tuple(do.shape)} "
                             f"must match q {tuple(q.shape)}")
        if (lse.dtype != torch.float32 or lse.shape != (b, hq, sq, 1)
                or not lse.is_contiguous() or lse.device != q.device):
            raise ValueError(f"flash_bwd: lse must be contiguous f32 {(b, hq, sq, 1)}")
        dq = torch.empty((b, hq, sq, d), dtype=torch.bfloat16, device=q.device)
        dk = torch.empty((b, hkv, skv, d), dtype=torch.bfloat16, device=q.device)
        dv = torch.empty((b, hkv, skv, d), dtype=torch.bfloat16, device=q.device)
        if dq.numel() == 0 or dk.numel() == 0:  # nothing to launch: zero gradients
            for t in (dq, dk, dv):
                t.zero_()
            return dq, dk, dv
        delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        inputs, d_in = (q, k, v, o, do), d
        if not all(tma_ready(t) for t in inputs):
            d_in = -(-d // 8) * 8
            inputs = tuple(padded_copy(t, d_in) for t in inputs)
            self.padded_copies += len(inputs)
        strides = [s for t in inputs for s in t.stride()[:3]]
        args = (*(t.data_ptr() for t in inputs), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), q_start.data_ptr(),
                kv_len.data_ptr(), b, hq, hkv, sq, skv, d, d_in, *strides, float(scale),
                int(causal))
        lib = self.build().lib
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            check_launch("flash_bwd dq", lib.flash_bwd_dq_bf16(*args, stream))
            self.dq_launches += 1
            check_launch("flash_bwd dkv", lib.flash_bwd_dkv_bf16(*args, stream))
            self.dkv_launches += 1
        return dq, dk, dv


flash_fwd = FlashForward()
flash_bwd = FlashBackward()


class FlashAttention(torch.autograd.Function):
    """Differentiable attention under the module's mask rule; the PyTorch
    counterpart of the JAX ``custom_vjp`` around the flash kernels. With
    ``kernel`` it pairs the CUDA forward with the CUDA backward, otherwise
    ``mha_reference_lse`` with ``mha_backward_reference``. Returns (O, LSE);
    the LSE is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, q_start, kv_len, causal: bool, scale: float, kernel: bool):
        if kernel:
            o, lse = flash_fwd(q, k, v, q_start, kv_len, causal, scale)
        else:
            o, lse = mha_reference_lse(q, k, v, causal=causal, q_start=q_start,
                                       kv_len=kv_len, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse, q_start, kv_len)
        ctx.causal, ctx.scale, ctx.kernel = causal, scale, kernel
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, q_start, kv_len = ctx.saved_tensors
        if ctx.kernel:
            if do.stride(-1) != 1:  # e.g. the expanded gradient of a sum
                do = do.contiguous()
            dq, dk, dv = flash_bwd(q, k, v, o, lse, do, q_start, kv_len, ctx.causal, ctx.scale)
        else:
            dq, dk, dv = mha_backward_reference(q, k, v, o, lse, do, causal=ctx.causal,
                                                q_start=q_start, kv_len=kv_len, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None, None


def mha(q, k, v, *, causal: bool = True, q_start: Lens = None,
        kv_len: Lens = None, scale: Optional[float] = None,
        implementation: str = "auto", with_lse: bool = False):
    """Multi-head attention under the module's mask rule.

    implementation: 'auto' (the plain version for CPU tensors, the CUDA
    kernels for CUDA tensors), 'kernel' (CUDA tensors only) or 'plain'.
    Both go through :class:`FlashAttention`, so the output is differentiable
    in q, k and v. Returns O, or (O, LSE) with ``with_lse``.
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
    if implementation not in ("plain", "kernel"):
        raise ValueError(f"unknown implementation {implementation!r}")
    if implementation == "kernel" and not q.is_cuda:
        raise ValueError("implementation='kernel' needs CUDA tensors")
    qs, kl = _normalize_lens(b, sq, skv, q_start, kv_len, q.device)
    out = FlashAttention.apply(q, k, v, qs, kl, causal, scale, implementation == "kernel")
    return out if with_lse else out[0]
