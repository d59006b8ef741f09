"""ctypes bindings for the port's LZ4 block codec (``native/lz4.cpp``).

Counterpart of ``fvsrn_tpu/volume/lz4io.py``. The codec is built with
``g++`` on first use into ``build/fvsrn_tpu_torch/lz4-<hash>.so`` at the
repository root (``utils.native``). A failed build raises with the
compiler's output: nothing falls back to uncompressed writes.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..utils import native

SOURCE = native.source_path("lz4")
BUILD_DIR = native.BUILD_DIR

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    return native.library_path("lz4")


def build() -> str:
    """Compile the codec unless it is built already; returns its path."""
    return native.build("lz4")


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
