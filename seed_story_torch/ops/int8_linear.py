"""The base product of an int8 ``LoRADense`` or UNet ``QDense``: x (..., K)
times an int8 weight W (N, K) with a per-output-channel scale (N,),

    y = bf16( bf16(x W^T) * bf16(scale) )

(in ``x.dtype`` for the plain version), the rounding order of the JAX
package's ``jnp.dot(x, kernel.astype(dtype)) * scale.astype(dtype)``
(``seed_story_tpu/models/llama.py:294``, ``seed_story_tpu/models/sdxl/unet.py:63-77``).

``int8_linear(implementation="auto")`` takes the plain version for CPU
tensors. On CUDA tensors it launches a hand-written kernel, chosen by the
number of rows:
- at most 32 rows (decode, the K + 1 verify block, and B (K + 1) rows of B
  stories in lockstep): kernel A, ``csrc/int8_linear.cu`` (tensor cores in
  1, 2 or 4 n-tiles of 8 rows, a cp.async ring, K split across the blocks of
  a cluster; one row takes a CUDA-core kernel), which streams the int8
  bytes once;
- more than 32 rows (prefill, the int8 UNet, ``quantize_base`` training):
  kernel C, ``csrc/int8_gemm.cu``: wgmma on 128-row blocks fed by TMA, the
  int8 tile converted in shared memory into wgmma's swizzled B operand, which
  never writes a bf16 copy of W to device memory. The tensor cores bound the
  product and the shared-memory traffic of the conversion and of wgmma's
  operand reads bounds the kernel first; narrow outputs with a long
  contracted axis (attn2's to_k / to_v) take K slices on a cluster so that
  a few rows still fill the card (``Int8Gemm.plan``).
The gradient to x goes through kernel C's transposed form,
``dx = bf16( bf16(g * bf16(scale)) W )`` (``Int8LinearFunction``); W and the
scale take none. ``int8_linear_gathered`` takes W and the scale as this
rank's row slices of a data-parallel group (the ``fsdp`` presets' int8
base): it all-gathers them for the product and frees them, and gathers
them again for the gradient to x. There is no fallback: a CUDA input the
kernels do not take raises, and so does a failed build or launch.

``grouped_int8_linear`` is the same product for the routed experts of a
mixture of experts (``models/moe.py``): every held expert's int8 weight
(E, N, K) applied to the (token, expert) pairs routed to it, listed by a
sort on the device. On CUDA tensors it is one launch of
``csrc/grouped_int8.cu`` (kernel A's design per expert, the pair counts
read on the device, experts without pairs skipped); its plain version is a
loop over the experts.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.collectives import gather_rows
from .cuda_lib import BuiltLibrary, check_launch

MAX_KERNEL_ROWS = 32  # kernel A's rows; more rows take kernel C


def _check_operands(kernel: str, operands):
    """Raises unless every (name, tensor, dtype) of ``operands`` is a
    contiguous, 16-byte aligned CUDA tensor of that dtype on the first one's
    device."""
    device = operands[0][1].device
    for name, t, dtype in operands:
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{kernel}: {name} must be on {device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{kernel} takes {name} as {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous and 16-byte aligned")


def int8_linear_reference(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor):
    """The plain version: ``F.linear(x, W.to(x.dtype)) * scale.to(x.dtype)``."""
    return F.linear(x, weight.to(x.dtype)) * scale.to(x.dtype)


class Int8Linear:
    """Wrapper of the CUDA weight-only int8 product. ``launches`` counts the
    kernel launches made through it (under a lock: a de-tokenizer thread may
    launch kernels beside the decode loop); nothing else touches the count."""

    ROWS = 64          # output channels of a block of the mma kernel
    STAGE_K = 256      # columns of a stage; a K slice is a multiple of it
    MAX_SLICES = 8     # a K slice a block of one thread block cluster
    BLOCKS_PER_SM = 2
    GEMV_MAX_ROWS = 1  # rows that take the CUDA-core kernel (see csrc/int8_linear.cu)

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._built: Optional[BuiltLibrary] = None
        self._sms = {}

    def build(self) -> BuiltLibrary:
        if self._built is None:
            built = BuiltLibrary("int8_linear")
            fn = built.lib.int8_linear_bf16
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._built = built
        return self._built

    def k_slices(self, device, n: int, k: int) -> Tuple[int, int]:
        """(columns per K slice, slices): about 2 blocks per multiprocessor,
        at most 8 slices. It depends on N and K only, so a row of x is summed
        in the same order whatever the number of rows beside it."""
        if device not in self._sms:
            self._sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
        groups = -(-n // self.ROWS)
        stages = -(-k // self.STAGE_K)
        want = min(stages, self.MAX_SLICES,
                   max(1, round(self.BLOCKS_PER_SM * self._sms[device] / groups)))
        k_range = -(-stages // want) * self.STAGE_K
        return k_range, -(-k // k_range)

    def __call__(self, x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor):
        """x (..., K) bf16 with at most 32 rows, weight (N, K) int8, scale (N,)
        f32; CUDA tensors on one device, contiguous, 16-byte aligned, K a
        multiple of 16. Returns (..., N) bf16."""
        _check_operands("int8_linear", (("x", x, torch.bfloat16), ("weight", weight, torch.int8),
                                        ("scale", scale, torch.float32)))
        n, k = weight.shape
        m = x.numel() // k if k else 0
        if x.shape[-1] != k or scale.shape != (n,):
            raise ValueError(f"int8_linear: bad shapes x={tuple(x.shape)} "
                             f"weight={tuple(weight.shape)} scale={tuple(scale.shape)}")
        if not 1 <= m <= MAX_KERNEL_ROWS:
            raise ValueError(f"int8_linear takes 1..{MAX_KERNEL_ROWS} rows, got {m}")
        if k % 16:
            raise ValueError(f"int8_linear takes K a multiple of 16, got {k}")
        y = torch.empty((*x.shape[:-1], n), dtype=torch.bfloat16, device=x.device)
        fn = self.build().lib.int8_linear_bf16
        k_range = self.k_slices(x.device, n, k)[0]
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            check_launch("int8_linear", fn(x.data_ptr(), weight.data_ptr(), scale.data_ptr(),
                                           y.data_ptr(), m, n, k, k_range,
                                           int(m <= self.GEMV_MAX_ROWS), stream))
        with self._lock:
            self.launches += 1
        return y


int8_linear_kernel = Int8Linear()


class Int8Gemm:
    """Wrapper of kernel C, the int8 GEMM for more than 32 rows: the forward
    product (``__call__``) and its transposed form (``transposed``, the
    gradient to x). ``launches`` counts every launch of either form (under a
    lock, as ``Int8Linear``), ``transposed_launches`` those of the transposed
    form; nothing else touches them.

    ``plan`` fixes, from N and K alone, the order in which every output sums
    its contracted axis: in K slices of whole stages, added in slice order.
    ``launch_plan`` adds what may depend on M and changes no output's sum:
    the block's output width (128 or 256 columns; wgmma sums each output's
    16 products a step alike at either width) and whether one block adds the
    slices itself or a cluster of blocks takes a slice each. So a row's
    output does not depend on the rows beside it."""

    MULTIPLE = 64     # N and K must be multiples of it
    STAGE = 64        # contracted columns of a stage
    ROWS = 128        # rows of a block
    MAX_SLICES = 8    # the portable cluster size
    MIN_SLICE_STAGES = 4
    WIDE_SPLIT_STAGES = 8  # slices this long amortize a cluster's fill and merge

    def __init__(self):
        self.launches = 0
        self.transposed_launches = 0
        self._lock = threading.Lock()
        self._built: Optional[BuiltLibrary] = None
        self._sms = {}

    def build(self) -> BuiltLibrary:
        if self._built is None:
            built = BuiltLibrary("int8_gemm")
            fn = built.lib.int8_gemm_bf16
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._built = built
        return self._built

    @classmethod
    def plan(cls, n: int, k: int, transposed: bool, sms: int) -> Tuple[int, int]:
        """(stages of 64 contracted columns a K slice, slices) for W (n, k) on a
        card of ``sms`` multiprocessors. A narrow output (its 128-column tiles
        fill at most an eighth of the card) that contracts over more than its
        width gets slices, enough for about one block per multiprocessor with
        one 128-row tile (at most 8, each at least 4 stages): a few rows of it
        would otherwise run few long blocks. Others take one slice."""
        cols, contracted = (k, n) if transposed else (n, k)
        stages = contracted // cls.STAGE
        tiles = -(-cols // 128)
        want = 1
        if 8 * tiles <= sms and contracted > cols:
            want = max(1, min(cls.MAX_SLICES, stages // cls.MIN_SLICE_STAGES, -(-sms // tiles)))
        per_slice = -(-stages // want)
        return per_slice, -(-stages // per_slice)

    def launch_plan(self, device, m: int, n: int, k: int,
                    transposed: bool) -> Tuple[int, int, bool]:
        """(block output width, stages of a K slice, split). Sliced outputs
        split when one 128-column block a tile would fill at most half the
        card; else they split on 256-column blocks where the width allows and
        a slice is long enough to amortize the cluster's fill and merge, or
        take 128-column blocks that add the slices themselves (one block
        keeps the finished slices' sum in registers, room it has at 128
        columns only). Unsliced outputs take 256 columns where the width
        allows and 256-column tiles fill at least half the card, else 128."""
        if device not in self._sms:
            self._sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
        sms = self._sms[device]
        cols = k if transposed else n
        per_slice, slices = self.plan(n, k, transposed, sms)
        row_tiles = -(-m // self.ROWS)
        if slices > 1:
            if 2 * -(-cols // 128) * row_tiles <= sms:
                return 128, per_slice, True
            if cols % 256 == 0 and per_slice >= self.WIDE_SPLIT_STAGES:
                return 256, per_slice, True
            return 128, per_slice, False
        wide = cols % 256 == 0 and 2 * (cols // 256) * row_tiles >= sms
        return (256 if wide else 128), per_slice, False

    def _launch(self, a: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                transposed: bool, with_plan=None) -> torch.Tensor:
        """One launch of either form; ``with_plan`` (block width, stages a
        slice, split) replaces ``launch_plan``'s, for measurements and tests
        that compare plans."""
        _check_operands("int8_gemm", (("g" if transposed else "x", a, torch.bfloat16),
                                      ("weight", weight, torch.int8),
                                      ("scale", scale, torch.float32)))
        n, k = weight.shape
        inner, outer = (n, k) if transposed else (k, n)
        if a.shape[-1] != inner or scale.shape != (n,):
            raise ValueError(f"int8_gemm: bad shapes {'g' if transposed else 'x'}="
                             f"{tuple(a.shape)} weight={tuple(weight.shape)} "
                             f"scale={tuple(scale.shape)}")
        if n % self.MULTIPLE or k % self.MULTIPLE or not n or not k:
            raise ValueError(f"int8_gemm takes N and K multiples of {self.MULTIPLE}, "
                             f"got N={n}, K={k}")
        m = a.numel() // inner
        if m < 1:
            raise ValueError("int8_gemm takes at least one row")
        bn, per_slice, split = with_plan or self.launch_plan(a.device, m, n, k, transposed)
        out = torch.empty((*a.shape[:-1], outer), dtype=torch.bfloat16, device=a.device)
        fn = self.build().lib.int8_gemm_bf16
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            check_launch("int8_gemm", fn(a.data_ptr(), weight.data_ptr(), scale.data_ptr(),
                                         out.data_ptr(), m, n, k, int(transposed), bn,
                                         per_slice, int(split), stream))
        with self._lock:
            self.launches += 1
            self.transposed_launches += int(transposed)
        return out

    def __call__(self, x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor):
        """y (..., N) = bf16(bf16(x W^T) * bf16(scale)) for x (..., K) bf16,
        weight (N, K) int8, scale (N,) f32: CUDA tensors on one device,
        contiguous, 16-byte aligned; N and K multiples of 64."""
        return self._launch(x, weight, scale, transposed=False)

    def transposed(self, g: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor):
        """dx (..., K) = bf16(bf16(g * bf16(scale)) W) for g (..., N) bf16:
        the gradient of ``__call__`` to x."""
        return self._launch(g, weight, scale, transposed=True)


int8_gemm_kernel = Int8Gemm()


def _launch_kernel(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor):
    """Kernel A for at most 32 rows, kernel C above."""
    x = x.contiguous()
    rows = x.numel() // max(1, x.shape[-1])
    if rows <= MAX_KERNEL_ROWS:
        return int8_linear_kernel(x, weight, scale)
    return int8_gemm_kernel(x, weight, scale)


class Int8LinearFunction(torch.autograd.Function):
    """The kernels' product with a gradient to x through kernel C's
    transposed form; the int8 weight and its scale are frozen and take no
    gradient."""

    @staticmethod
    def forward(ctx, x, weight, scale):
        ctx.save_for_backward(weight, scale)
        return _launch_kernel(x, weight, scale)

    @staticmethod
    def backward(ctx, g):
        weight, scale = ctx.saved_tensors
        return int8_gemm_kernel.transposed(g.contiguous(), weight, scale), None, None


def int8_linear_grad_reference(g: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor):
    """The plain gradient to x of :func:`int8_linear_reference`:
    ``(g * scale.to(g.dtype)) W.to(g.dtype)``."""
    return (g * scale.to(g.dtype)).matmul(weight.to(g.dtype))


class GatheredInt8LinearFunction(torch.autograd.Function):
    """The product on an int8 weight held as row slices over a process
    group: the forward all-gathers W and its scale (int8 stays int8), runs
    the product on them (kernel A or C on CUDA, the plain version on the
    CPU) and lets them go; the backward gathers them again for the gradient
    to x (kernel C's transposed form on CUDA). This is FSDP's reshard after
    the forward, by hand, for the integer weights FSDP does not hold. The
    gathered W is the whole weight bit for bit, so every row's result is
    the one-process product's."""

    @staticmethod
    def forward(ctx, x, weight, scale, rows, group):
        ctx.save_for_backward(weight, scale)
        ctx.rows, ctx.group = rows, group
        w, s = gather_rows(weight, rows, group), gather_rows(scale, rows, group)
        return _launch_kernel(x, w, s) if x.is_cuda else int8_linear_reference(x, w, s)

    @staticmethod
    def backward(ctx, g):
        weight, scale = ctx.saved_tensors
        w, s = gather_rows(weight, ctx.rows, ctx.group), gather_rows(scale, ctx.rows, ctx.group)
        if g.is_cuda:
            dx = int8_gemm_kernel.transposed(g.contiguous(), w, s)
        else:
            dx = int8_linear_grad_reference(g, w, s)
        return dx, None, None, None, None


def int8_linear_gathered(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                         rows: int, group):
    """:func:`int8_linear` on the whole weight of which ``weight`` (c, K)
    and ``scale`` (c,) are this rank's rows of ``group`` (each rank's c
    rows in rank order, cut to ``rows``; ``parallel.sharding.row_slice``):
    the kernels on CUDA tensors, the plain version on CPU tensors, a
    gradient to x when x requires one."""
    return GatheredInt8LinearFunction.apply(x, weight, scale, rows, group)


def int8_linear(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                implementation: str = "auto"):
    """x (..., K) times the int8 ``weight`` (N, K) with ``scale`` (N,).

    implementation: 'auto' (plain on CPU tensors, the kernels on CUDA
    tensors), 'kernel' (CUDA tensors only: kernel A for at most 32 rows,
    kernel C above) or 'plain'. On the kernels, a gradient to x flows when x
    requires one."""
    if implementation == "auto":
        implementation = "kernel" if x.is_cuda else "plain"
    if implementation == "plain":
        return int8_linear_reference(x, weight, scale)
    if implementation != "kernel":
        raise ValueError(f"unknown implementation {implementation!r}")
    if not x.is_cuda:
        raise ValueError("implementation='kernel' needs CUDA tensors")
    if torch.is_grad_enabled() and x.requires_grad:
        return Int8LinearFunction.apply(x, weight, scale)
    return _launch_kernel(x, weight, scale)


def grouped_int8_linear_reference(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                                  order: torch.Tensor, offsets: torch.Tensor,
                                  in_div: int) -> torch.Tensor:
    """The plain version of :func:`grouped_int8_linear`: a loop over the
    experts, each pair's row of ``int8_linear_reference`` on its expert's
    weight; rows of no listed pair are zero."""
    out = x.new_zeros((order.shape[0], weight.shape[1]))
    bounds = offsets.tolist()
    for e in range(weight.shape[0]):
        pairs = order[bounds[e]:bounds[e + 1]].long()
        if len(pairs):
            out[pairs] = int8_linear_reference(x[pairs // in_div], weight[e], scale[e])
    return out


class GroupedInt8Linear:
    """Wrapper of the grouped int8 expert kernel (``csrc/grouped_int8.cu``).
    ``launches`` counts its launches (under a lock, as ``Int8Linear``);
    nothing else touches the count."""

    ROWS = 64          # output channels of a block
    STAGE_K = 256      # columns of a stage; a K slice is a multiple of it
    MAX_SLICES = 8
    BLOCKS_PER_SM = 2

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._built: Optional[BuiltLibrary] = None
        self._sms = {}

    def build(self) -> BuiltLibrary:
        if self._built is None:
            built = BuiltLibrary("grouped_int8")
            fn = built.lib.grouped_int8_bf16
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._built = built
        return self._built

    def k_range(self, device, experts: int, n: int, k: int) -> int:
        """Columns of a K slice: about 2 blocks per multiprocessor were every
        expert hit, at most 8 slices. It depends on the shapes only, never
        on how the pairs fall, so a pair is summed in the same order however
        many pairs share its expert."""
        if device not in self._sms:
            self._sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
        blocks = experts * -(-n // self.ROWS)
        stages = -(-k // self.STAGE_K)
        want = min(stages, self.MAX_SLICES,
                   max(1, round(self.BLOCKS_PER_SM * self._sms[device] / blocks)))
        return -(-stages // want) * self.STAGE_K

    def __call__(self, x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                 order: torch.Tensor, offsets: torch.Tensor, in_div: int) -> torch.Tensor:
        """x (R, K) bf16, weight (E, N, K) int8, scale (E, N) f32, order (P,)
        and offsets (E + 1,) int32: CUDA tensors on one device, contiguous,
        16-byte aligned (order and offsets 4-byte), K a multiple of 16.
        Returns (P, N) bf16, zero in the rows of no listed pair."""
        _check_operands("grouped_int8", (("x", x, torch.bfloat16),
                                         ("weight", weight, torch.int8),
                                         ("scale", scale, torch.float32)))
        for name, t in (("order", order), ("offsets", offsets)):
            if t.device != x.device or t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError(f"grouped_int8: {name} must be contiguous int32 on {x.device}")
        experts, n, k = weight.shape
        if (x.dim() != 2 or x.shape[1] != k or scale.shape != (experts, n)
                or offsets.shape != (experts + 1,) or order.dim() != 1):
            raise ValueError(f"grouped_int8: bad shapes x={tuple(x.shape)} "
                             f"weight={tuple(weight.shape)} scale={tuple(scale.shape)} "
                             f"order={tuple(order.shape)} offsets={tuple(offsets.shape)}")
        if k % 16 or in_div < 1 or x.shape[0] * in_div < order.shape[0]:
            raise ValueError(f"grouped_int8 takes K a multiple of 16 and in_div >= 1 covering "
                             f"the pairs, got K={k}, in_div={in_div}")
        y = torch.zeros((order.shape[0], n), dtype=torch.bfloat16, device=x.device)
        if order.shape[0] == 0:
            return y
        fn = self.build().lib.grouped_int8_bf16
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            check_launch("grouped_int8", fn(x.data_ptr(), weight.data_ptr(), scale.data_ptr(),
                                            order.data_ptr(), offsets.data_ptr(), y.data_ptr(),
                                            experts, n, k, self.k_range(x.device, experts, n, k),
                                            in_div, stream))
        with self._lock:
            self.launches += 1
        return y


grouped_int8_kernel = GroupedInt8Linear()


def grouped_int8_linear(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                        order: torch.Tensor, offsets: torch.Tensor, in_div: int,
                        implementation: str = "auto") -> torch.Tensor:
    """The routed experts' int8 products: (P, N) with row p = the product
    of x's row ``p // in_div`` with expert e's weight (N, K) and scale (N,)
    for each pair p listed in ``order[offsets[e]:offsets[e + 1]]``; rows of
    no listed pair are zero. ``weight`` (E, N, K) int8, ``scale`` (E, N),
    ``order`` (P,) and ``offsets`` (E + 1,) int32.

    implementation: 'auto' (the plain loop over experts on CPU tensors, the
    CUDA kernel on CUDA tensors), 'kernel' or 'plain'."""
    if implementation == "auto":
        implementation = "kernel" if x.is_cuda else "plain"
    if implementation == "plain":
        return grouped_int8_linear_reference(x, weight, scale, order, offsets, in_div)
    if implementation != "kernel":
        raise ValueError(f"unknown implementation {implementation!r}")
    if not x.is_cuda:
        raise ValueError("implementation='kernel' needs CUDA tensors")
    return grouped_int8_kernel(x.contiguous(), weight, scale, order, offsets, in_div)
