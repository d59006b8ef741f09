"""ctypes bindings for the port's LZ4 block codec (``native/lz4.cpp``).

Counterpart of ``fvsrn_tpu/volume/lz4io.py``. The codec is built with
``g++`` on first use into ``build/fvsrn_tpu_torch/lz4-<hash>.so`` at the
repository root, keyed by a hash of the source and the flags, and
written to a temporary file first and moved into place, so processes
that build at once each find a whole library. A failed build raises
with the compiler's output: nothing falls back to uncompressed writes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(PKG_DIR, "native", "lz4.cpp")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "fvsrn_tpu_torch")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lz4-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the codec unless it is built already; returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.fv_lz4_compress_bound.restype = ctypes.c_int
            lib.fv_lz4_compress_bound.argtypes = [ctypes.c_int]
            lib.fv_lz4_compress.restype = ctypes.c_int
            lib.fv_lz4_compress.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            lib.fv_lz4_decompress.restype = ctypes.c_int
            lib.fv_lz4_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            lib.fv_lz4_decompress_prefix.restype = ctypes.c_int
            lib.fv_lz4_decompress_prefix.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int]
            _lib = lib
        return _lib


def compress(data: bytes) -> bytes:
    """One LZ4 block of ``data``."""
    lib = _load()
    bound = lib.fv_lz4_compress_bound(len(data))
    out = ctypes.create_string_buffer(bound)
    n = lib.fv_lz4_compress(data, len(data), out, bound)
    if n <= 0:
        raise RuntimeError("LZ4 compression failed")
    return out.raw[:n]


def decompress(data: bytes, raw_len: int) -> bytes:
    """The ``raw_len`` bytes of one LZ4 block."""
    lib = _load()
    out = ctypes.create_string_buffer(raw_len)
    n = lib.fv_lz4_decompress(data, len(data), out, raw_len)
    if n != raw_len:
        raise RuntimeError(f"LZ4 decompression failed (code {n})")
    return out.raw


def decompress_into(data: bytes, out: np.ndarray, pos: int) -> int:
    """Decode the block ``data`` into the uint8 buffer ``out`` at offset
    ``pos``; matches may reach back into ``out[:pos]`` up to the LZ4
    window, min(pos, 65535) bytes (the streamed chunks' dictionary
    continuation). Returns the number of bytes produced."""
    if out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be a contiguous uint8 array")
    if not 0 <= pos <= out.size:
        raise ValueError(f"pos {pos} outside the buffer of {out.size} B")
    lib = _load()
    n = lib.fv_lz4_decompress_prefix(data, len(data), out.ctypes.data + pos,
                                     out.size - pos, min(pos, 65535))
    if n < 0:
        raise RuntimeError(f"LZ4 chunk decompression failed (code {n})")
    return n
