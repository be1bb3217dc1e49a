"""Build and load the port's hand-written CUDA kernels.

Each source under `csrc/` exposes a plain C launcher and is compiled on
first use with `nvcc` into its own shared library, loaded with `ctypes`
(no PyTorch headers, so one build takes seconds). Libraries go to
`dual_space_nerf_tpu_torch/_build/` (ignored by git), named by a hash of
the source and flags, so an edited source is never served a stale build.
`build_all` starts one `nvcc` per source at once and waits for all.

Nothing here runs at import: the CPU tests import every module on a
machine without `nvcc` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# No --use_fast_math: the kernels spell out IEEE-rounded arithmetic and must
# agree bit for bit with their plain PyTorch versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


class CudaKernel:
    """One `csrc/<source>` library with one C launcher ``symbol``.

    The launcher takes device pointers and the stream as ``c_void_p`` and
    returns `cudaGetLastError()` after its launch; `launch` raises if that is
    not 0 and counts one launch. ``launches`` is a plain integer that a run
    reads to show the kernel was on its path.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None

    @property
    def name(self) -> str:
        return os.path.splitext(self.source)[0]

    def library_path(self) -> str:
        path = os.path.join(CSRC_DIR, self.source)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return os.path.join(BUILD_DIR, f"lib{self.name}_{digest[:16]}.so")

    def start_build(self):
        """Start nvcc for this source unless its library exists; returns
        (process, temp path, library path) for `finish_build`, or None.
        nvcc writes a per-process temp name, renamed when it is done."""
        out = self.library_path()
        if os.path.exists(out):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, out = started
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{log}")
        os.replace(tmp, out)

    def _function(self):
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(self.library_path())
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        err = self._function()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1


def build_all(kernels) -> float:
    """Build every kernel's library in parallel (one nvcc each); load them.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    started = [(k, k.start_build()) for k in kernels]
    for k, s in started:
        k.finish_build(s)
    for k in kernels:
        k._function()
    return time.perf_counter() - t0


def stream_ptr(device) -> int:
    """The current PyTorch stream of ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
