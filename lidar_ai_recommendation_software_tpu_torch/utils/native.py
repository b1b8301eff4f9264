"""ctypes bridge to the native C++ parsing library.

Compiles ``native/loader.cpp`` (a byte-identical copy of the JAX package's)
on first use with g++ into the package's ``_build/`` directory (keyed on
the source's hash; no pip, no pybind11) and exposes typed wrappers. Every
entry point has a NumPy twin, so the package works without a toolchain;
with it, text ingest runs ~20-50x faster than the reference's per-line
Python loops (utils/data_processing.py:68-76). A host parser, not a
device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG_DIR = Path(__file__).resolve().parents[1]
_SRC = _PKG_DIR / "native" / "loader.cpp"
BUILD_DIR = _PKG_DIR / "_build"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[str]:
    try:
        src = _SRC.read_bytes()
    except OSError:
        return None
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = BUILD_DIR / f"libloader_{tag}.so"
    if out.exists():
        return str(out)
    # a name of this process's own: test workers may build at once
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
             "-o", str(tmp)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return str(out)
    except (subprocess.SubprocessError, OSError):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled library, or None when unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.parse_xyz_text.restype = ctypes.c_size_t
        lib.parse_xyz_text.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_double), ctypes.c_size_t]
        lib.parse_las_points.restype = ctypes.c_size_t
        lib.parse_las_points.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double)]
        lib.count_lines.restype = ctypes.c_size_t
        lib.count_lines.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.lzf_decompress.restype = ctypes.c_size_t
        lib.lzf_decompress.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return get_lib() is not None


def parse_xyz_text(data: bytes) -> Optional[np.ndarray]:
    """Parse text rows of >=3 numbers; None when the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    max_rows = lib.count_lines(data, len(data)) + 1
    out = np.empty((max_rows, 3), dtype=np.float64)
    n = lib.parse_xyz_text(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_rows)
    return out[:n].copy()


def parse_las_points(data: bytes, point_offset: int, record_len: int,
                     n_points: int, scale, offset) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty((n_points, 3), dtype=np.float64)
    n = lib.parse_las_points(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        point_offset, record_len, n_points,
        float(scale[0]), float(scale[1]), float(scale[2]),
        float(offset[0]), float(offset[1]), float(offset[2]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out[:n]


def lzf_decompress(data: bytes, expected_size: int) -> Optional[bytes]:
    """LZF decompression (PCD binary_compressed bodies). Uses the native
    library when available; falls back to a pure-Python decoder (same
    liblzf stream format) so the loader works without a toolchain.
    Returns None on malformed input."""
    lib = get_lib()
    if lib is not None:
        src = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(expected_size, dtype=np.uint8)
        n = lib.lzf_decompress(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            expected_size)
        return out[:n].tobytes() if n == expected_size else None
    return _lzf_decompress_py(data, expected_size)


def _lzf_decompress_py(data: bytes, expected_size: int) -> Optional[bytes]:
    out = bytearray()
    ip, n = 0, len(data)
    while ip < n:
        c = data[ip]
        ip += 1
        if c < 32:
            run = c + 1
            if ip + run > n:
                return None
            out += data[ip:ip + run]
            ip += run
        else:
            length = c >> 5
            if length == 7:
                if ip >= n:
                    return None
                length += data[ip]
                ip += 1
            if ip >= n:
                return None
            dist = ((c & 0x1F) << 8 | data[ip]) + 1
            ip += 1
            ref = len(out) - dist
            if ref < 0:
                return None
            for _ in range(length + 2):   # overlapping copies by design
                out.append(out[ref])
                ref += 1
    return bytes(out) if len(out) == expected_size else None
