"""Builds the package's CUDA sources (``seed_story_torch/csrc/*.cu``) at
first use and loads them with ctypes.

Each source has a plain C interface, so ``nvcc`` compiles it in seconds
without PyTorch's headers. The shared library lands in
``seed_story_torch/_build/`` (git-ignored) under a name keyed by a hash of
the source and the shared ``csrc/*.cuh`` headers, so an edited kernel is
rebuilt and a built one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# sm_90a: Hopper with its architecture-specific instructions (wgmma, setmaxnreg).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def check_launch(kernel: str, err: int):
    """Raises on a C entry point's non-zero return: a CUDA error code, or
    1000 + the CUresult of a tensor map that could not be encoded."""
    if err != 0:
        what = (f"tensor map encode failed with CUresult {err - 1000}" if err >= 1000
                else f"CUDA error {err}")
        raise RuntimeError(f"{kernel} launch failed: {what}")


class BuiltLibrary:
    """One compiled source: the loaded library plus how its build went."""

    def __init__(self, name: str):
        src = CSRC_DIR / f"{name}.cu"
        h = hashlib.sha256(src.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):  # shared headers rebuild every user
            h.update(header.read_bytes())
        digest = h.hexdigest()[:16]
        path = BUILD_DIR / f"{name}_{digest}.so"
        log = path.with_suffix(".log")
        self.build_seconds = 0.0
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                tmp_path = pathlib.Path(tmp) / path.name
                cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp_path), str(src)]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src.name} (exit {res.returncode}):\n"
                        f"{res.stdout}\n{res.stderr}")
                log.write_text(res.stdout + res.stderr)
                os.replace(tmp_path, path)  # atomic: concurrent builds agree
            self.build_seconds = time.perf_counter() - t0
        self.path = path
        self.ptxas_log = log.read_text() if log.exists() else ""
        self.lib = ctypes.CDLL(str(path))
