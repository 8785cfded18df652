"""Host-side native code: CRC32C for the wire.

The counterpart of ``fedcrack_tpu.native.crc32c``. ``crc32c.cpp`` builds
at first use with the host C++ compiler into ``fedcrack_tpu_torch/_build/``
(keyed by a hash of the source, the flags and the CPU's feature line,
since it is built ``-march=native``) and loads through ``ctypes``. There
is no silent fallback: the frames checksum every upload, and a Python
loop costs about 0.3 s per MiB, so a failed build raises.
:func:`crc32c_table` is the table-driven Python version, kept to check
the compiled one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Any

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "crc32c.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib: Any = None
_lock = threading.Lock()


def _cpu_tag() -> str:
    feats = ""
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = line
                    break
    except OSError:
        pass
    return platform.machine() + feats


def build() -> str:
    """Compile ``crc32c.cpp`` unless a library from the same source, flags
    and CPU exists; returns its path. Raises when the compiler fails."""
    with open(SOURCE, "rb") as f:
        source = f.read()
    key = source + " ".join(CXX_FLAGS).encode() + _cpu_tag().encode()
    path = os.path.join(BUILD_DIR, f"libfedcrack_crc32c_{hashlib.sha256(key).hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) to build fedcrack_tpu_torch/native/crc32c.cpp")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) building {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path


def _load() -> Any:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                fn = lib.fedcrack_torch_crc32c
                fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
                fn.restype = ctypes.c_uint32
                _lib = fn
    return _lib


def _byte_view(data: Any) -> np.ndarray:
    """The bytes to checksum, without a copy where the buffer allows it
    (an array: its full C-order byte image)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).view(np.uint8).ravel()
    return np.frombuffer(data, np.uint8) if len(data) else np.zeros(0, np.uint8)


def crc32c(data: bytes | bytearray | memoryview | np.ndarray, init: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, continuing from ``init``."""
    buf = _byte_view(data)
    return int(_load()(buf.ctypes.data, buf.size, init & 0xFFFFFFFF))


_TABLE: list[int] = []


def crc32c_table(data: bytes | bytearray | memoryview | np.ndarray, init: int = 0) -> int:
    """The same checksum by a byte-at-a-time table walk in Python."""
    if not _TABLE:
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
            _TABLE.append(crc)
    crc = ~init & 0xFFFFFFFF
    for b in _byte_view(data).tobytes():
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return (~crc) & 0xFFFFFFFF
