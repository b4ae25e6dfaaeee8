"""The attention probes' kernels: the counterparts of the six Pallas kernels
of ``benchmarks/probe_attn_variants.py``, ``probe_attn_overhead.py`` and
``probe_attn_dma.py``, each with its plain PyTorch version beside it.

- :func:`attn`: full-mask online-softmax attention over key blocks of
  ``block_kv``, in three variants (``base``: natural exp; ``exp2``: the
  scale folded with log2 e; ``noexp``: P = scale * S, no max, alpha = 1);
  on the card blocks of ``block_q`` query rows of one head, one or two an
  SM (:func:`attn_plan`).
- :func:`copy_only`: O = Q + V per head, K brought on chip and unused: the
  traffic of attention's I/O with no math; on the card in blocks of (head,
  span) (:func:`copy_plan`).
- :func:`single_pass`: softmax(scale * Q K^T) V with one max per row over
  the whole sequence, one program per (b, h): on the card a cluster of
  blocks a head (:func:`single_pass_plan`).
- :func:`single_pass_fused_bh`: the same, two heads per program.
- :func:`attn_packed2`: two d = 64 heads packed side by side in 128-wide
  rows (the TPU's lane-width trick), each running the single pass.

The kernels are CUDA C++ for Hopper in ``csrc/probe_attn.cu``, built at
first use by :class:`~seed_story_torch.ops.cuda_lib.BuiltLibrary`.
``implementation="auto"`` runs the plain version on CPU tensors and the
kernel on CUDA tensors; ``"kernel"`` on a CPU tensor raises, and nothing
falls back when a build or a launch fails. Every kernel takes contiguous
bf16 (B, H, S, 64) tensors (the copy any head dim whose rows are whole
16-byte units); each wrapper counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple, Optional

import torch

from ..ops.cuda_lib import BuiltLibrary, check_launch

LOG2E = 1.4426950408889634
VARIANTS = ("base", "exp2", "noexp")
# (block_q, block_kv) instances of the online kernel: query rows a block (one
# consumer warpgroup a 64 rows) and keys a tile of its TMA ring. The TPU
# probe's blocks of 256-1024 rows do not fit a block's registers and shared
# memory on the card; the probe sweeps these instead.
TILES = ((128, 128), (128, 64), (64, 128), (64, 64))
HEAD_DIM = 64

_lib: Optional[BuiltLibrary] = None
_lib_lock = threading.Lock()


def build() -> BuiltLibrary:
    """``csrc/probe_attn.cu``, built once and shared by the five wrappers."""
    global _lib
    with _lib_lock:
        if _lib is None:
            built = BuiltLibrary("probe_attn")
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            built.lib.probe_attn.argtypes = [ptr] * 4 + [i32] * 6 + [ctypes.c_float, ptr]
            built.lib.probe_single_pass.argtypes = [ptr] * 4 + [i32] * 6 + [ctypes.c_float, ptr]
            built.lib.probe_copy_only.argtypes = [ptr] * 4 + [i32, ctypes.c_longlong, i32, i32,
                                                              ptr]
            built.lib.probe_attn_info.argtypes = [i32] * 3 + [ctypes.POINTER(i32)]
            for name in ("probe_attn", "probe_single_pass", "probe_copy_only", "probe_attn_info"):
                getattr(built.lib, name).restype = ctypes.c_int
            _lib = built
    return _lib


class ProbeKernel:
    """One probe kernel's wrapper: ``launches`` counts the calls that
    launched it (under a lock); nothing else touches the count.
    ``last_plan`` is the launch plan of the latest launch."""

    def __init__(self, name: str, entry: str):
        self.name, self.entry = name, entry
        self.launches = 0
        self.last_plan: Optional[NamedTuple] = None
        self._lock = threading.Lock()

    def build(self) -> BuiltLibrary:
        return build()

    def launch(self, out: torch.Tensor, *args, plan: Optional[NamedTuple] = None):
        fn = getattr(self.build().lib, self.entry)
        with torch.cuda.device(out.device):
            err = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
        check_launch(self.name, err)
        with self._lock:
            self.launches += 1
            self.last_plan = plan
        return out


probe_attn = ProbeKernel("probe_attn", "probe_attn")
probe_copy_only = ProbeKernel("probe_copy_only", "probe_copy_only")
probe_single_pass = ProbeKernel("probe_single_pass", "probe_single_pass")
probe_single_pass_fused_bh = ProbeKernel("probe_single_pass_fused_bh", "probe_single_pass")
probe_attn_packed2 = ProbeKernel("probe_attn_packed2", "probe_single_pass")
KERNELS = (probe_attn, probe_copy_only, probe_single_pass, probe_single_pass_fused_bh,
           probe_attn_packed2)


def _route(implementation: str, q: torch.Tensor) -> bool:
    """True for the kernel, False for the plain version."""
    if implementation == "auto":
        return q.is_cuda
    if implementation not in ("plain", "kernel"):
        raise ValueError(f"unknown implementation {implementation!r}")
    if implementation == "kernel" and not q.is_cuda:
        raise ValueError("implementation='kernel' needs CUDA tensors")
    return implementation == "kernel"


def _check_qkv(name: str, q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name} takes q, k, v of one (B, H, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def _kernel_inputs(name: str, q, k, v, head_dim: Optional[int] = HEAD_DIM,
                   seq_multiple: int = 1):
    """What every probe kernel takes: contiguous bf16 tensors on one card."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"{name} takes bfloat16 q, k, v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{name} takes contiguous q, k, v")
    b, h, s, d = q.shape
    if head_dim is not None and d != head_dim:
        raise ValueError(f"{name} takes head dim {head_dim}, got {d}")
    if s % seq_multiple:
        raise ValueError(f"{name} takes a sequence that is a multiple of {seq_multiple}, got {s}")


# ----------------------------------------------------------------- attn ---

def attn_reference(q, k, v, variant: str = "base", block_kv: int = 128):
    """Plain version of the variants' kernel: the same online recurrence over
    key blocks of ``block_kv`` in f32, P rounded to v's dtype before PV (the
    JAX ``p.astype(v_ref.dtype)``), and a zero row sum read as 1."""
    b, h, s, d = q.shape
    scale = 1.0 / (d ** 0.5)
    qf = q.float()
    m = torch.full((b, h, s, 1), -math.inf, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, d), device=q.device)
    for j0 in range(0, s, block_kv):
        sc = qf @ k[:, :, j0:j0 + block_kv].float().transpose(-1, -2)
        if variant == "noexp":
            p = sc * scale  # stand-in: no softmax at all
            m_new, alpha = m, 1.0
            l = l + p.sum(-1, keepdim=True)
        else:
            exp = torch.exp2 if variant == "exp2" else torch.exp
            sc = sc * (scale * LOG2E if variant == "exp2" else scale)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = exp(sc - m_new)
            alpha = exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
        pv = p.to(v.dtype).float() @ v[:, :, j0:j0 + block_kv].float()
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


def _check_tile(s: int, block_q: int, block_kv: int):
    if (block_q, block_kv) not in TILES:
        raise ValueError(f"attn: no instance for blocks ({block_q}, {block_kv}) on the card; "
                         f"one of {TILES}")
    if s % block_q or s % block_kv:
        raise ValueError(f"attn: sequence {s} is not a multiple of blocks "
                         f"({block_q}, {block_kv})")


ATTN_WARPGROUP_ROWS = 64  # query rows a consumer warpgroup of the online kernel
ATTN_ROW_BYTES = 2 * HEAD_DIM  # a bf16 row of Q, K or V in shared memory
SMEM_PER_BLOCK = 232448  # an H100's shared memory a block may have (227 KB)
SMEM_PER_SM = 233472  # an SM's (228 KB); each resident block takes 1 KB more


class AttnPlan(NamedTuple):
    """The online kernel's launch: ``blocks`` of ``block_q`` query rows of
    one head (grid (S / block_q, H, B)), each with ``warpgroups`` consumer
    warpgroups and a producer warp (``threads``), a ring of ``stages`` K / V
    stages in ``smem_bytes`` of dynamic shared memory, ``blocks_per_sm``
    resident on an SM, so the grid takes ``rounds`` rounds on ``sms``
    SMs."""

    block_q: int
    block_kv: int
    warpgroups: int
    threads: int
    stages: int
    smem_bytes: int
    blocks_per_sm: int
    grid: tuple
    blocks: int
    sms: int
    rounds: int


def attn_plan(b: int, h: int, s: int, block_q: int, block_kv: int, sms: int) -> AttnPlan:
    """The launch of the online kernel's instance ``(block_q, block_kv)``
    over B x H heads of S rows on ``sms`` SMs, as ``csrc/probe_attn.cu``
    sizes it (``online::Smem``): 64-row blocks hold a 96 KB ring so that
    two share an SM, 128-row blocks a 128 KB ring, one an SM."""
    _check_tile(s, block_q, block_kv)
    warpgroups = block_q // ATTN_WARPGROUP_ROWS
    blocks_per_sm = 2 if warpgroups == 1 else 1
    stage = 2 * block_kv * ATTN_ROW_BYTES  # a K tile and a V tile
    stages = (96 << 10 if warpgroups == 1 else 128 << 10) // stage
    barriers = 8 * (1 + 2 * stages)  # Q's, and a full and an empty one a stage
    smem = block_q * ATTN_ROW_BYTES + stages * stage + barriers + 1024  # + room to align
    grid = (s // block_q, h, b)
    blocks = grid[0] * h * b
    return AttnPlan(block_q, block_kv, warpgroups, 128 * warpgroups + 32, stages, smem,
                    blocks_per_sm, grid, blocks, sms, -(-blocks // (sms * blocks_per_sm)))


def attn_instance(variant: str, block_q: int, block_kv: int, device=None) -> dict:
    """What the card says of an instance of the online kernel: its dynamic
    shared memory, stages, threads, the blocks an SM holds (the runtime's
    occupancy count) and its registers a thread at launch."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = build().lib.probe_attn_info(VARIANTS.index(variant), block_q, block_kv, out)
    check_launch("probe_attn_info", err)
    return dict(zip(("smem_bytes", "stages", "threads", "blocks_per_sm", "registers"), out))


def attn(q, k, v, variant: str = "base", block_q: int = 128, block_kv: int = 128, *,
         implementation: str = "auto"):
    """Full-mask attention of (B, H, S, 64) q, k, v in one of
    :data:`VARIANTS`, tiled as ``(block_q, block_kv)`` (one of
    :data:`TILES`; S a multiple of both); the counterpart of ``attn`` in
    ``benchmarks/probe_attn_variants.py``. ``noexp`` returns acc / sum(scale
    * S), whose denominator may come near 0."""
    _check_qkv("attn", q, k, v)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    b, h, s, d = q.shape
    _check_tile(s, block_q, block_kv)
    if not _route(implementation, q):
        return attn_reference(q, k, v, variant, block_kv)
    _kernel_inputs("probe_attn", q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plan = attn_plan(b, h, s, block_q, block_kv, _sms(q.device.index))
    return probe_attn.launch(out, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                             b, h, s, VARIANTS.index(variant), block_q, block_kv,
                             1.0 / math.sqrt(d), plan=plan)


def noexp_error(q, k, got, want) -> float:
    """How far ``got`` is from ``want``, two ``noexp`` outputs of the same
    q and k, relative to what that variant's conditioning allows (<= tol
    passes). noexp returns O = acc / l with l = sum_j scale S_ij, whose
    sign is random, so l comes near 0 on some rows. The measure is, over
    every element, |O - O_ref| |l| / (max |O_ref l| + |O_ref| sum_j |scale
    S_ij|): the first term bounds the error of the numerator acc, the second
    that of a denominator summed from terms of that size in another order.
    Computed in f64, the scores made one batch row at a time."""
    l, mag = [], []
    for i in range(q.shape[0]):
        s = (q[i].double() @ k[i].double().transpose(-1, -2)) / math.sqrt(q.shape[-1])
        l.append(s.sum(-1, keepdim=True))
        mag.append(s.abs().sum(-1, keepdim=True))
        del s
    l, mag = torch.stack(l), torch.stack(mag)
    want = want.double()
    err = (got.double() - want).abs() * l.abs()
    return float((err / ((want * l).abs().max() + want.abs() * mag)).max())


# ------------------------------------------------------------ copy_only ---

COPY_MAX_SPAN = 2048  # 16-byte units a block: 32 KB, 8 a thread of the kernel
COPY_MIN_SPAN = 64  # 1 KB
COPY_BLOCKS_PER_SM = 4


class CopyPlan(NamedTuple):
    """The copy's grid: blocks of (head, span), each ``span_units`` 16-byte
    units of its head (the head's last span may be shorter)."""

    head_units: int
    span_units: int
    spans_per_head: int
    blocks: int


def copy_plan(b: int, h: int, s: int, d: int, sms: int) -> CopyPlan:
    """Spans of a power of two of 16-byte units, 1-32 KB, cut so that the
    grid has at least ``COPY_BLOCKS_PER_SM`` blocks an SM (of ``sms``)
    wherever the tensors are large enough; a span never crosses a head's
    end."""
    head_units = s * d // 8
    target = b * h * head_units // (COPY_BLOCKS_PER_SM * sms)
    span = COPY_MIN_SPAN
    while span * 2 <= min(target, COPY_MAX_SPAN):
        span *= 2
    span = min(span, head_units)
    spans = -(-head_units // span)
    return CopyPlan(head_units, span, spans, b * h * spans)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def copy_only(q, k, v, *, implementation: str = "auto"):
    """O = Q + V per (b, h) head, with K's block brought on chip and unused;
    the counterpart of ``copy_only`` in ``benchmarks/probe_attn_overhead.py``
    and ``probe_attn_dma.py`` (the latter's ``dimension_semantics`` is a TPU
    megacore hint with no counterpart in a CUDA grid). The kernel's sum is
    f32 rounded once to bf16, as ``q + v`` is."""
    _check_qkv("copy_only", q, k, v)
    if not _route(implementation, q):
        return q + v
    _kernel_inputs("probe_copy_only", q, k, v, head_dim=None)
    b, h, s, d = q.shape
    if (s * d) % 8:
        raise ValueError(f"probe_copy_only takes heads of whole 16-byte units, got S x D = "
                         f"{s} x {d}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plan = copy_plan(b, h, s, d, _sms(q.device.index))
    return probe_copy_only.launch(out, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), b * h, plan.head_units, plan.span_units,
                                  plan.spans_per_head, plan=plan)


# ---------------------------------------------------------- single pass ---

SINGLE_PASS_SEQ = 64  # S a multiple of it
SP_ROWS = 128  # query rows a block of the kernel
SP_MAX_CLUSTER = 8  # blocks a cluster: the portable limit, and the kernel's


class SinglePassPlan(NamedTuple):
    """The single pass's grid: ``groups`` heads (or head pairs), each on
    ``clusters_per_group`` clusters of ``cluster`` blocks; block i of a
    group owns query rows ``SP_ROWS * i`` onward (rows from S on are not
    stored, and a block wholly past S only helps load its cluster's
    tiles)."""

    groups: int
    cluster: int
    clusters_per_group: int
    clusters: int
    blocks: int


def single_pass_plan(b: int, h: int, s: int, heads_per_block: int,
                     max_cluster: int = SP_MAX_CLUSTER) -> SinglePassPlan:
    """The launch plan of the single pass over B x H heads of S rows,
    ``heads_per_block`` heads a program (2 for packed pairs): a head's
    ceil(S / 128) row blocks in as few clusters of at most ``max_cluster``
    as will hold them, the clusters of one size. A smaller ``max_cluster``
    than the default is for tests that hold the bits across plans."""
    if not 1 <= max_cluster <= SP_MAX_CLUSTER:
        raise ValueError(f"clusters take 1 to {SP_MAX_CLUSTER} blocks, got {max_cluster}")
    groups = b * h // heads_per_block
    row_blocks = -(-s // SP_ROWS)
    per_group = -(-row_blocks // max_cluster)
    cluster = -(-row_blocks // per_group)
    return SinglePassPlan(groups, cluster, per_group, groups * per_group,
                          groups * per_group * cluster)


def single_pass_reference(q, k, v):
    """Plain single pass: the (S, S) f32 scores materialized, one max per
    row, P rounded to v's dtype before PV, O = PV / sum(P)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s_ = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.exp(s_ - s_.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    pv = p.to(v.dtype).float() @ v.float()
    return (pv / l).to(q.dtype)


def _single_pass_launch(kernel: ProbeKernel, q, k, v, heads_per_block: int, packed: bool,
                        max_cluster: int = SP_MAX_CLUSTER):
    """The single-pass kernel over contiguous (B, H, S, 64), or packed
    (B, H/2, S, 128) head pairs: ``heads_per_block`` heads a program, on
    the clusters of :func:`single_pass_plan`."""
    _kernel_inputs(kernel.name, q, k, v, head_dim=2 * HEAD_DIM if packed else HEAD_DIM,
                   seq_multiple=SINGLE_PASS_SEQ)
    b, h, s, _ = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plan = single_pass_plan(b, h * (2 if packed else 1), s, heads_per_block, max_cluster)
    return kernel.launch(out, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         plan.groups, heads_per_block, int(packed), s, plan.cluster,
                         plan.clusters_per_group, 1.0 / math.sqrt(HEAD_DIM), plan=plan)


def single_pass(q, k, v, *, implementation: str = "auto"):
    """softmax(scale * Q K^T) V of (B, H, S, 64) q, k, v with one max per row
    over the whole sequence and one program per (b, h); the counterpart of
    ``single_pass`` in ``benchmarks/probe_attn_overhead.py``. The kernel
    takes S a multiple of 64."""
    _check_qkv("single_pass", q, k, v)
    if not _route(implementation, q):
        return single_pass_reference(q, k, v)
    return _single_pass_launch(probe_single_pass, q, k, v, 1, packed=False)


def single_pass_fused_bh(q, k, v, *, implementation: str = "auto"):
    """:func:`single_pass` with two heads a program on a flattened
    (B * H / 2) grid (B * H even); the counterpart of
    ``single_pass_fused_bh`` in ``benchmarks/probe_attn_overhead.py``."""
    _check_qkv("single_pass_fused_bh", q, k, v)
    b, h, s, d = q.shape
    if (b * h) % 2:
        raise ValueError(f"single_pass_fused_bh takes an even B x H, got {b} x {h}")
    if not _route(implementation, q):
        return single_pass_reference(q, k, v)
    return _single_pass_launch(probe_single_pass_fused_bh, q, k, v, 2, packed=False)


def pack_pairs(x):
    """(B, H, S, 64) -> (B, H/2, S, 128): heads 2i and 2i + 1 side by side."""
    b, h, s, d = x.shape
    return x.reshape(b, h // 2, 2, s, d).transpose(2, 3).reshape(b, h // 2, s, 2 * d)


def unpack_pairs(x):
    """(B, H/2, S, 128) -> (B, H, S, 64), the inverse of :func:`pack_pairs`."""
    b, hp, s, dd = x.shape
    return x.reshape(b, hp, s, 2, dd // 2).transpose(2, 3).reshape(b, 2 * hp, s, dd // 2)


def attn_packed2(q, k, v, *, implementation: str = "auto"):
    """Single-pass attention of (B, H, S, 64) q, k, v (H even) with head
    pairs packed into 128-wide rows around the kernel, each half its own
    head; the counterpart of ``attn_packed2`` in
    ``benchmarks/probe_attn_dma.py``."""
    _check_qkv("attn_packed2", q, k, v)
    b, h, s, d = q.shape
    if d != HEAD_DIM or h % 2:
        raise ValueError(f"attn_packed2 takes head dim 64 and an even head count, got "
                         f"{tuple(q.shape)}")
    kernel = _route(implementation, q)
    qp, kp, vp = pack_pairs(q), pack_pairs(k), pack_pairs(v)
    if kernel:
        out = _single_pass_launch(probe_attn_packed2, qp, kp, vp, 2, packed=True)
    else:
        out = torch.cat([single_pass_reference(qp[..., sl], kp[..., sl], vp[..., sl])
                         for sl in (slice(0, d), slice(d, 2 * d))], dim=-1)
    return unpack_pairs(out)
