"""ctypes bindings for the port's adaptive arithmetic bitplane coder
(``native/arith.cpp``) -- the entropy stage of the compression tower
(counterpart of ``fvsrn_tpu/arith.py``; reference: the tthresh
arithmetic coder + RLE the reference vendors,
compression/src/compression.cpp:1-821).

The coder is built with ``g++`` on first use into
``build/fvsrn_tpu_torch/arith-<hash>.so`` (``utils.native``); a failed
build raises with the compiler's output, so :func:`available` is True or
raises: the codecs never fall back to another entropy stage.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from .utils import native

SOURCE = native.source_path("arith")

_lock = threading.Lock()
_lib_handle = None


def library_path() -> str:
    return native.library_path("arith")


def _lib() -> ctypes.CDLL:
    global _lib_handle
    with _lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(native.build("arith"))
            lib.fv_ac_encode_planes.restype = ctypes.c_int
            lib.fv_ac_encode_planes.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int]
            lib.fv_ac_decode_planes.restype = ctypes.c_int
            lib.fv_ac_decode_planes.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.fv_ac_encode_planes3d.restype = ctypes.c_int
            lib.fv_ac_encode_planes3d.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
            lib.fv_ac_decode_planes3d.restype = ctypes.c_int
            lib.fv_ac_decode_planes3d.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            _lib_handle = lib
        return _lib_handle


def available() -> bool:
    """The 1D coder (builds the library on first use; raises if it
    cannot)."""
    return hasattr(_lib(), "fv_ac_encode_planes")


def available3d() -> bool:
    """The 3D-context coder (as :func:`available`)."""
    return hasattr(_lib(), "fv_ac_encode_planes3d")


def _encode(fn, mag, sign, shape_args, nbits) -> bytes:
    """Run an encoder with the JAX package's output capacity, retrying
    once with a worst-case buffer on overflow."""
    n = mag.size
    for cap in (max(1024, n * max(1, nbits) // 4 + n + 4096),
                n * max(1, nbits) + 4096):
        out = np.empty(cap, np.uint8)
        m = fn(mag.ctypes.data, sign.ctypes.data, *shape_args, int(nbits),
               out.ctypes.data, cap)
        if m >= 0:
            return out[:m].tobytes()
    raise RuntimeError("arithmetic coder output overflow")


def encode_planes(mag: np.ndarray, sign: np.ndarray, nbits: int) -> bytes:
    """Entropy-code |coefficients| (uint64) + signs over ``nbits``
    bitplanes MSB-first with adaptive significance/refinement/sign
    contexts. Returns the payload."""
    lib = _lib()
    mag = np.ascontiguousarray(mag, np.uint64)
    sign = np.ascontiguousarray(sign, np.uint8)
    return _encode(lib.fv_ac_encode_planes, mag, sign, (mag.size,), nbits)


def decode_planes(payload: bytes, n: int, nbits: int):
    """Inverse of :func:`encode_planes` -> (mag uint64 (n,), sign uint8
    (n,))."""
    lib = _lib()
    mag = np.zeros(n, np.uint64)
    sign = np.zeros(n, np.uint8)
    rc = lib.fv_ac_decode_planes(payload, len(payload),
                                 mag.ctypes.data, sign.ctypes.data,
                                 n, int(nbits))
    if rc != 0:
        raise RuntimeError("arithmetic decode failed")
    return mag, sign


def encode_planes3d(mag: np.ndarray, sign: np.ndarray,
                    nbits: int) -> bytes:
    """3D-context bitplane coding of a (n0, n1, n2) magnitude volume:
    significance contexts keyed on the six face neighbors' state
    (EBCOT-style; native fv_ac_encode_planes3d)."""
    lib = _lib()
    mag = np.ascontiguousarray(mag, np.uint64)
    if mag.ndim != 3:
        raise ValueError("encode_planes3d needs a 3D array")
    sign = np.ascontiguousarray(sign, np.uint8).reshape(mag.shape)
    return _encode(lib.fv_ac_encode_planes3d, mag, sign, mag.shape, nbits)


def decode_planes3d(payload: bytes, shape, nbits: int):
    """Inverse of :func:`encode_planes3d` -> (mag uint64 shape, sign
    uint8 shape)."""
    lib = _lib()
    n0, n1, n2 = (int(s) for s in shape)
    mag = np.zeros((n0, n1, n2), np.uint64)
    sign = np.zeros((n0, n1, n2), np.uint8)
    rc = lib.fv_ac_decode_planes3d(payload, len(payload),
                                   mag.ctypes.data, sign.ctypes.data,
                                   n0, n1, n2, int(nbits))
    if rc != 0:
        raise RuntimeError("arithmetic decode failed")
    return mag, sign
