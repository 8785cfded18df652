"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` compiles with ``nvcc`` for sm_90a into
a shared library with a plain C interface, loaded with ``ctypes``. A
library is keyed by a hash of its source, the headers beside it
(``csrc/*.cuh``) and the compiler flags, so an edited source or header
rebuilds and an unchanged one is reused; nvcc's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside it
as ``<library>.so.log``. Nothing builds at import: a library builds at its
first launch (or when :func:`build_all` is called), on a host with the CUDA
toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# --split-compile=0: nvcc optimizes a source's kernel instantiations on
# every core at once (the GEMM's source has 78 of them).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
)

PTR = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong

# Every kernel library this process has loaded, each built first where its
# cache held none: the port's only run-time compiles (the serve command's
# ``serve_recompiles_total``).
_compiles = 0
_compiles_lock = threading.Lock()


def compile_count() -> int:
    """How many kernel libraries this process has loaded."""
    with _compiles_lock:
        return _compiles


def _count_compile() -> None:
    global _compiles
    with _compiles_lock:
        _compiles += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels build from "
            "fedcrack_tpu_torch/kernels/csrc/ at first use on a CUDA host"
        )
    return found


class KernelLibrary:
    """One ``csrc/<name>.cu`` source and the C entry points it exports.

    ``symbols`` maps each C entry point to its ``ctypes`` argument types;
    every entry point returns an ``int``. A launching entry point takes
    the CUDA stream as its last argument and returns 0 or the CUDA error
    of its launch (:meth:`launch`)."""

    def __init__(self, name: str, symbols: dict[str, list]):
        self.name = name
        self.source = os.path.join(_HERE, "csrc", f"{name}.cu")
        self.symbols = symbols
        self._lib: ctypes.CDLL | None = None
        self._fns: dict[str, ctypes._CFuncPtr] = {}
        self._lock = threading.Lock()

    def build(self) -> str:
        """Compile the source unless a library built from the same source,
        headers and flags exists; returns the library's path."""
        csrc = os.path.dirname(self.source)
        inputs = [self.source] + sorted(os.path.join(csrc, f) for f in os.listdir(csrc) if f.endswith(".cuh"))
        digest = hashlib.sha256()
        for path in inputs:
            with open(path, "rb") as f:
                digest.update(f.read())
        digest.update(" ".join(NVCC_FLAGS).encode())
        digest = digest.hexdigest()[:16]
        path = os.path.join(BUILD_DIR, f"libfedcrack_{self.name}_{digest}.so")
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {self.source}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        with open(f"{path}.log", "w", encoding="utf-8") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
        return path

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                for symbol, argtypes in self.symbols.items():
                    fn = getattr(lib, symbol)
                    fn.argtypes = argtypes
                    fn.restype = I32
                    self._fns[symbol] = fn
                self._lib = lib
                _count_compile()
            return self._lib

    def launch(self, symbol: str, device: torch.device, *args) -> None:
        """Launch ``symbol`` on ``device``'s current stream; raises on a
        launch error. Does not synchronise.

        The hot path of every wrapper: the entry point is resolved once,
        and the device is switched only when it is not the current one."""
        fn = self._fns.get(symbol)
        if fn is None:
            self.load()
            fn = self._fns[symbol]
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        if index == current:
            err = fn(*args, torch.cuda.current_stream(index).cuda_stream)
        else:
            with torch.cuda.device(index):
                err = fn(*args, torch.cuda.current_stream(index).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def build_all(libraries: list[KernelLibrary]) -> list[str]:
    """Build several libraries at once (one nvcc process each, started
    together); returns their paths in order."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        futures = [pool.submit(lib.build) for lib in libraries]
        return [f.result() for f in futures]
