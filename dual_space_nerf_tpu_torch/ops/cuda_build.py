"""Build and load the port's hand-written CUDA kernels and host decoders.

Each source under `csrc/` exposes a plain C launcher and is compiled on
first use with `nvcc` into its own shared library, loaded with `ctypes`
(no PyTorch headers, so one build takes seconds). The host-side image
image code (`csrc/jpeg_decode.c`, `csrc/png_unfilter.c`,
`csrc/remap_linear.c`) is plain C built the same way with the system C
compiler (`HostLibrary`). Libraries go to
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
import threading
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


# No contraction into FMA: the host code repeats cv2's float arithmetic
C_FLAGS = ("-std=c11", "-O2", "-ffp-contract=off", "-shared", "-fPIC")


def _cc() -> str:
    for cand in (shutil.which("cc"), shutil.which("gcc")):
        if cand:
            return cand
    raise RuntimeError("no C compiler (cc or gcc) found: the host image decoders build with it")


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


class SharedLibrary:
    """One `csrc/<source>` compiled into `_build/lib<name>_<hash>.so`.

    ``includes`` names the headers under `csrc/` that the source includes, so
    that an edited header rebuilds it; ``csrc`` may point at another tree's
    sources, to compare versions. The compiler and its flags are the
    subclass's (`_compiler`, `_flags`)."""

    _flags: tuple = NVCC_FLAGS

    def __init__(self, source: str, includes: tuple = (), csrc: str = CSRC_DIR):
        self.source = source
        self.includes = includes
        self.csrc = csrc
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()  # the loader's threads may ask at once

    @staticmethod
    def _compiler() -> str:
        return _nvcc()

    @property
    def name(self) -> str:
        return os.path.splitext(self.source)[0]

    def library_path(self) -> str:
        h = hashlib.sha256(" ".join(self._flags).encode())
        for name in (self.source, *self.includes):
            with open(os.path.join(self.csrc, name), "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"lib{stem}_{digest[:16]}.so")

    def start_build(self):
        """Start the compiler for this source unless its library exists;
        returns (process, temp path, library path) for `finish_build`, or
        None. The compiler writes a per-process temp name, renamed when it
        is done."""
        out = self.library_path()
        if os.path.exists(out):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [self._compiler(), *self._flags, "-o", tmp, os.path.join(self.csrc, self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, out = started
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"{os.path.basename(self._compiler())} failed for {self.source}:\n{log}")
        os.replace(tmp, out)

    def library(self) -> ctypes.CDLL:
        """The loaded library, built first if it is not in the cache."""
        if self._lib is not None:  # loaded: no lock, so a forked child never waits on one
            return self._lib
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                self._lib = ctypes.CDLL(self.library_path())
        return self._lib


class HostLibrary(SharedLibrary):
    """A plain C source for the host, built with the system C compiler."""

    _flags = C_FLAGS

    @staticmethod
    def _compiler() -> str:
        return _cc()

    def function(self, symbol: str, argtypes: list, restype=ctypes.c_int):
        fn = getattr(self.library(), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        return fn


class CudaKernel(SharedLibrary):
    """One `csrc/<source>` library with one C launcher ``symbol``.

    The launcher takes device pointers and the stream as ``c_void_p`` and
    returns `cudaGetLastError()` after its launch; `launch` raises if that is
    not 0 and counts one launch. ``launches`` is a plain integer that a run
    reads to show the kernel was on its path. ``name`` (default: the
    source's stem) tells apart two kernels of one library, which is built
    once.
    """

    def __init__(self, source: str, symbol: str, argtypes: list, includes: tuple = (),
                 csrc: str = CSRC_DIR, name: str | None = None):
        super().__init__(source, includes, csrc)
        self._label = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.base = None
        self._fn = None
        self._extra = {}

    @classmethod
    def entry_of(cls, base: "CudaKernel", symbol: str, name: str,
                 argtypes: list | None = None) -> "CudaKernel":
        """Another launcher of ``base``'s library, with its own name, launch
        count and (default: ``base``'s) argument types; ``.base`` is
        ``base``, whose build log holds both."""
        kernel = cls(base.source, symbol, argtypes or base.argtypes, base.includes, base.csrc,
                     name=name)
        kernel.base = base
        return kernel

    @property
    def name(self) -> str:
        return self._label or super().name

    def _function(self):
        if self._fn is None:
            fn = getattr(self.library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def extra_function(self, symbol: str, argtypes: list):
        """Another C function of the same library that launches nothing (an
        occupancy or size query); returns an int. Its calls count nothing."""
        self._function()
        if symbol not in self._extra:
            fn = getattr(self.library(), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            self._extra[symbol] = fn
        return self._extra[symbol]

    def launch(self, *args) -> None:
        err = self._function()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1


def build_all(kernels) -> float:
    """Build every kernel's library in parallel (one nvcc each); load them.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    started, paths = [], set()
    for k in kernels:  # one build per library, if two kernels share one
        path = k.library_path()
        started.append((k, None if path in paths else k.start_build()))
        paths.add(path)
    for k, s in started:
        k.finish_build(s)
    for k in kernels:
        k._function()
    return time.perf_counter() - t0


def stream_ptr(device) -> int:
    """The current PyTorch stream of ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
