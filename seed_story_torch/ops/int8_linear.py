"""The base product of an int8 ``LoRADense``: x (..., K) times an int8
weight W (N, K) with a per-output-channel scale (N,),

    y = bf16( bf16(x W^T) * bf16(scale) )

(in ``x.dtype`` for the plain version), the rounding order of the JAX
package's ``jnp.dot(x, kernel.astype(dtype)) * scale.astype(dtype)``
(``seed_story_tpu/models/llama.py:294``).

``int8_linear(implementation="auto")`` takes the plain version for CPU
tensors. On CUDA tensors with at most 32 rows (decode, the K + 1 verify
block, and B (K + 1) rows of B stories in lockstep) it launches the
hand-written kernel ``csrc/int8_linear.cu`` (tensor cores in 1, 2 or 4
n-tiles of 8 rows, a cp.async ring, K split across the blocks of a cluster;
one row takes a CUDA-core kernel), which streams the int8 bytes once; with
more rows (prefill, compute-bound) it runs the plain expression, a large
product that the JAX package leaves to XLA too. There is no fallback: a
CUDA input the kernel does not take raises, and so does a failed build or
launch.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .cuda_lib import BuiltLibrary, check_launch

MAX_KERNEL_ROWS = 32


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
        for name, t, dtype in (("x", x, torch.bfloat16), ("weight", weight, torch.int8),
                               ("scale", scale, torch.float32)):
            if not t.is_cuda or t.device != x.device:
                raise ValueError(f"int8_linear: {name} must be on {x.device}, got {t.device}")
            if t.dtype != dtype:
                raise TypeError(f"int8_linear takes {name} as {dtype}, got {t.dtype}")
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"int8_linear: {name} must be contiguous and 16-byte aligned")
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


def int8_linear(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                implementation: str = "auto"):
    """x (..., K) times the int8 ``weight`` (N, K) with ``scale`` (N,).

    implementation: 'auto' (plain on CPU tensors; on CUDA tensors the kernel
    for at most 32 rows, the plain expression above that), 'kernel' (CUDA
    tensors only) or 'plain'."""
    if implementation == "auto":
        rows = x.numel() // max(1, x.shape[-1])
        implementation = "kernel" if x.is_cuda and rows <= MAX_KERNEL_ROWS else "plain"
    if implementation == "plain":
        return int8_linear_reference(x, weight, scale)
    if implementation != "kernel":
        raise ValueError(f"unknown implementation {implementation!r}")
    if not x.is_cuda:
        raise ValueError("implementation='kernel' needs CUDA tensors")
    return int8_linear_kernel(x, weight, scale)
