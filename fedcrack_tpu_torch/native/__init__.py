"""Host-side native code: CRC32C for the wire, and the decode-side resize.

The counterpart of ``fedcrack_tpu.native``. Each C++ source builds at
first use with the host C++ compiler into ``fedcrack_tpu_torch/_build/``
(keyed by a hash of the source, the flags and the CPU's feature line,
since it is built ``-march=native``) and loads through ``ctypes``. There
is no silent fallback; a failed build raises:

- ``crc32c.cpp``: the frames checksum every upload, and a Python loop costs
  about 0.3 s per MiB. :func:`crc32c_table` is the table-driven Python
  version, kept to check the compiled one.
- ``resize.cpp``: :func:`resize_normalize`, :func:`resize_binarize`,
  :func:`resize_u8` and :func:`resize_binarize_u8`, the bilinear resize the
  image pipeline uses where OpenCV is absent and the skew sharding's mask
  scores always use. :func:`_resize_numpy` is its numpy version, byte for
  byte the same (both round every float32 operation in the same order).
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
CRC32C_SOURCE = os.path.join(_HERE, "crc32c.cpp")
RESIZE_SOURCE = os.path.join(_HERE, "resize.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# No fused multiply-add: the resize must round as its numpy version does on
# any host CPU.
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")

_libs: dict[str, Any] = {}
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


def build(source: str) -> str:
    """Compile ``source`` unless a library from the same source, flags and
    CPU exists; returns its path. Raises when the compiler fails."""
    with open(source, "rb") as f:
        text = f.read()
    key = text + " ".join(CXX_FLAGS).encode() + _cpu_tag().encode()
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(BUILD_DIR, f"libfedcrack_{stem}_{hashlib.sha256(key).hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"no host C++ compiler (g++ or c++) to build {source}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, source], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) building {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path


def _load(source: str) -> Any:
    lib = _libs.get(source)
    if lib is None:
        with _lock:
            lib = _libs.get(source)
            if lib is None:
                lib = ctypes.CDLL(build(source))
                if source == CRC32C_SOURCE:
                    lib.fedcrack_torch_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
                    lib.fedcrack_torch_crc32c.restype = ctypes.c_uint32
                else:
                    shape = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                    lib.fedcrack_torch_resize_f32.argtypes = shape + [ctypes.c_float, ctypes.c_int,
                                                                      ctypes.c_float]
                    lib.fedcrack_torch_resize_f32.restype = None
                    lib.fedcrack_torch_resize_u8.argtypes = shape + [ctypes.c_int, ctypes.c_float]
                    lib.fedcrack_torch_resize_u8.restype = None
                _libs[source] = lib
    return lib


def _byte_view(data: Any) -> np.ndarray:
    """The bytes to checksum, without a copy where the buffer allows it
    (an array: its full C-order byte image)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).view(np.uint8).ravel()
    return np.frombuffer(data, np.uint8) if len(data) else np.zeros(0, np.uint8)


def crc32c(data: bytes | bytearray | memoryview | np.ndarray, init: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, continuing from ``init``."""
    buf = _byte_view(data)
    return int(_load(CRC32C_SOURCE).fedcrack_torch_crc32c(buf.ctypes.data, buf.size, init & 0xFFFFFFFF))


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


def _as_u8_3d(image: np.ndarray) -> np.ndarray:
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3:
        raise ValueError(f"expected HxW[xC] image, got shape {image.shape}")
    return np.ascontiguousarray(image, dtype=np.uint8)


def _resize(image: np.ndarray, size: int, scale: float, binarize: bool, thresh: float,
            out_dtype) -> np.ndarray:
    src = _as_u8_3d(image)
    h, w, ch = src.shape
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    dst = np.empty((size, size, ch), out_dtype)
    lib = _load(RESIZE_SOURCE)
    if out_dtype == np.uint8:
        lib.fedcrack_torch_resize_u8(src.ctypes.data, h, w, ch, dst.ctypes.data, size, size,
                                     int(binarize), thresh)
    else:
        lib.fedcrack_torch_resize_f32(src.ctypes.data, h, w, ch, dst.ctypes.data, size, size,
                                      scale, int(binarize), thresh)
    return dst


def resize_normalize(image: np.ndarray, size: int) -> np.ndarray:
    """uint8 HxWxC -> float32 size x size x C in [0, 1]: bilinear, then
    times 1/255 (the image contract)."""
    return _resize(image, size, 1.0 / 255.0, False, 0.0, np.float32)


def resize_binarize(image: np.ndarray, size: int, thresh: float = 0.5) -> np.ndarray:
    """uint8 HxW[x1] -> float32 {0, 1} size x size x 1: bilinear, then
    ``> thresh``. The default 0.5 reproduces OpenCV's uint8 ``resize(mask) >
    0``, which rounds the interpolation to nearest first."""
    out = _resize(image, size, 1.0, True, thresh, np.float32)
    return out if out.shape[-1] == 1 else out[..., :1]


def resize_u8(image: np.ndarray, size: int) -> np.ndarray:
    """uint8 HxWxC -> uint8 size x size x C: bilinear, rounded to nearest
    (the uint8 transport's decode; the device applies the /255)."""
    return _resize(image, size, 1.0, False, 0.0, np.uint8)


def resize_binarize_u8(image: np.ndarray, size: int, thresh: float = 0.5) -> np.ndarray:
    """uint8 HxW[x1] -> uint8 {0, 1} size x size x 1 with the labels of
    :func:`resize_binarize`."""
    out = _resize(image, size, 1.0, True, thresh, np.uint8)
    return out if out.shape[-1] == 1 else out[..., :1]


def _resize_numpy(src: np.ndarray, size: int, scale: float, binarize: bool, thresh: float,
                  out_dtype=np.float32) -> np.ndarray:
    """The plain version of ``resize.cpp`` (uint8 HxWxC ``src``): the same
    float32 operations in the same order, so the same bytes."""
    f = np.float32
    h, w, _ = src.shape

    def axis(n_src: int):
        pos = (np.arange(size, dtype=f) + f(0.5)) * (f(n_src) / f(size)) - f(0.5)
        pos = np.minimum(np.maximum(f(0.0), pos), f(n_src - 1))
        i0 = pos.astype(np.int64)
        return i0, np.minimum(i0 + 1, n_src - 1), pos - i0.astype(f)

    y0, y1, wy = axis(h)
    x0, x1, wx = axis(w)
    wy, omwy = wy[:, None, None], (f(1.0) - wy)[:, None, None]
    wx, omwx = wx[None, :, None], (f(1.0) - wx)[None, :, None]
    s = src.astype(f)
    v = (omwy * omwx) * s[y0][:, x0] + (omwy * wx) * s[y0][:, x1]
    v = v + (wy * omwx) * s[y1][:, x0]
    v = v + (wy * wx) * s[y1][:, x1]
    out = (v > f(thresh)).astype(f) if binarize else v * f(scale)
    if out_dtype == np.uint8:
        return (out + f(0.5)).astype(np.uint8)
    return out
