"""Volume compression baselines (counterpart of
``fvsrn_tpu/compression.py``).

Rebuild of the reference's compression tower
(reference: compression/src/compression.cpp:1-821 TThresh + cudaCompress
wrappers exposed as ``pyrenderer.compression``, bindings.cpp:285-606, with
allocation tracking in memtrace.cpp): the baselines the SRN is compared
against (reference: applications/volnet/eval_CompressionTeaser.py).
The codecs are NumPy on the host, as tthresh and its coder are host code
in the reference, and their payloads equal the JAX package's byte for
byte: the same pickled dicts (key order, Python numbers) around the
port's own LZ4 (``volume/lz4io.py``) and arithmetic coder (``arith.py``).

Codecs:
- ``tthresh``: full HOSVD + error-driven bitplane truncation + adaptive
  arithmetic coding with significance/refinement/sign contexts
  (``native/arith.cpp``), factors quantized per column and coded too.
- ``tucker``: HOSVD/Tucker decomposition with energy-threshold rank
  truncation plus fp16 factor storage and LZ4.
- ``dwt``: multi-level CDF 9/7 lifting DWT + deadzone quantization +
  per-subband arithmetic bitplane coding -- the cudaCompress pipeline
  shape; ``dwt_chunked`` adds the per-brick payload structure for
  interactive decompression (decode only the bricks a view touches, like
  compression_cu.cu).
- ``quantize``: uniform scalar quantization to b bits + LZ4.

Both native libraries build on first use and raise if they cannot, so
there is no fallback stage: the JAX package's fallback payloads (written
when its native library cannot build) are refused, as are payloads of
another arithmetic coder version (``acver``), by ``decompress_dwt`` as by
``decompress_tthresh``. ``MemoryTracker`` mirrors the reference's
allocation bookkeeping.
"""
from __future__ import annotations

import io
import pickle
import struct
from dataclasses import dataclass

import numpy as np

from . import arith
from .volume import lz4io


@dataclass
class CompressionResult:
    payload: bytes
    compressed_bytes: int
    raw_bytes: int
    psnr: float

    @property
    def ratio(self) -> float:
        return self.raw_bytes / max(self.compressed_bytes, 1)


class MemoryTracker:
    """Peak/current allocation bookkeeping
    (reference: compression/src/memtrace.cpp)."""

    def __init__(self):
        self.current = 0
        self.peak = 0

    def alloc(self, nbytes: int):
        self.current += nbytes
        self.peak = max(self.peak, self.current)

    def free(self, nbytes: int):
        self.current -= nbytes


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64))
                        ** 2))
    if mse == 0:
        return float("inf")
    rng = float(a.max() - a.min()) or 1.0
    return 10.0 * np.log10(rng * rng / mse)


def _mode_product(core: np.ndarray, factor: np.ndarray,
                  mode: int) -> np.ndarray:
    """core x_mode factor (factor: (new_dim, old_dim))."""
    core = np.moveaxis(core, mode, 0)
    shape = core.shape
    out = factor @ core.reshape(shape[0], -1)
    out = out.reshape((factor.shape[0],) + shape[1:])
    return np.moveaxis(out, 0, mode)


def compress_tucker(volume: np.ndarray, energy: float = 1e-4,
                    tracker: MemoryTracker | None = None
                    ) -> CompressionResult:
    """Tucker/HOSVD compression with relative energy threshold.

    volume: (X, Y, Z) float array. ``energy`` is the fraction of squared
    norm allowed to be discarded per mode (smaller = higher quality).
    """
    v = np.asarray(volume, np.float32)
    if tracker:
        tracker.alloc(v.nbytes)
    core = v.astype(np.float64)
    factors = []
    for mode in range(3):
        unfold = np.moveaxis(core, mode, 0).reshape(core.shape[mode], -1)
        u, s, _ = np.linalg.svd(unfold, full_matrices=False)
        cum = np.cumsum(s[::-1] ** 2)[::-1]
        total = float((s ** 2).sum()) or 1.0
        rank = int(np.searchsorted(-cum, -energy * total) or 1)
        rank = max(1, min(rank, len(s)))
        factors.append(u[:, :rank])
        core = _mode_product(core, u[:, :rank].T, mode)
    blob = {
        "shape": v.shape,
        "core": core.astype(np.float32),
        "factors": [f.astype(np.float16) for f in factors],
    }
    raw = pickle.dumps(blob)
    data = struct.pack("<ii", len(raw), 1) + lz4io.compress(raw)
    rec = decompress_tucker(data)
    if tracker:
        tracker.free(v.nbytes)
    return CompressionResult(payload=data, compressed_bytes=len(data),
                             raw_bytes=v.nbytes, psnr=_psnr(v, rec))


def decompress_tucker(data: bytes) -> np.ndarray:
    raw_len, compressed = struct.unpack("<ii", data[:8])
    body = data[8:]
    raw = lz4io.decompress(body, raw_len) if compressed else body
    blob = pickle.loads(raw)
    core = blob["core"].astype(np.float64)
    for mode, f in enumerate(blob["factors"]):
        core = _mode_product(core, f.astype(np.float64), mode)
    return core.astype(np.float32)


def _quantize_factors(factors: list[np.ndarray], sigmas: list[np.ndarray],
                      eps_f: float, vnorm: float):
    """TThresh factor coding (the paper's scheme; the vendored codec the
    reference wraps likewise bitplane-codes the factors,
    compression/src/tthresh/encode.hpp): per-COLUMN uniform quantization
    with steps allocated from the HOSVD slice norms, then one adaptive
    arithmetic pass over all quantized entries.

    Error model (exact for HOSVD): perturbing mode-k factor columns by
    ``du_i`` changes the reconstruction by ``sum_i sigma_i^2 ||du_i||^2``
    per mode (core slices along each mode are mutually orthogonal with
    norms sigma_i). Worst-case uniform-quantization column error is
    ``sqrt(n) * delta_i / 2``, so setting
    ``delta_i = 2 E_m / (sqrt(R) sqrt(n) sigma_i)`` with per-mode budget
    ``E_m = eps_f * ||v|| / 3`` bounds the total factor error by
    ``eps_f * ||v||`` (triangle inequality over the three modes).
    Equal per-column ERROR allocation is the rate-optimal split (bits
    grow logarithmically in 1/delta). Tiny-sigma columns get huge steps
    -> all-zero columns -> a fraction of a bit each under the coder.

    The worst-case bound is ~3x conservative in practice (uniform
    quantization RMS is worst/sqrt(3), and cross-mode errors add near
    quadrature, not linearly), so the per-column steps are scaled by a
    GLOBAL multiplier bisected against the MEASURED per-mode error
    ``sqrt(sum_i sigma_i^2 ||du_i||^2)`` (exact within a mode) summed in
    quadrature across modes, targeting 0.85 of the budget -- the rate
    responds to eps instead of paying bits the error never uses.

    Returns (mags uint64, signs uint8, deltas f32 per column, ranks).
    """
    if vnorm <= 0.0:
        # all-zero volume: factors reconstruct to zero regardless --
        # emit zero quanta with unit steps (avoids 0-step divisions)
        mags, signs, deltas, ranks = [], [], [], []
        for f in factors:
            n, r = f.shape
            ranks.append(r)
            mags.append(np.zeros(n * r, np.uint64))
            signs.append(np.zeros(n * r, np.uint8))
            deltas.append(np.ones(r, np.float32))
        return (np.concatenate(mags), np.concatenate(signs),
                np.concatenate(deltas), ranks)
    e_m = eps_f * vnorm / 3.0
    base_deltas = []
    for f, sig in zip(factors, sigmas):
        n, r = f.shape
        col_budget = e_m / np.sqrt(r)
        safe_sig = np.maximum(np.asarray(sig, np.float64), 1e-300)
        base_deltas.append(2.0 * col_budget / (np.sqrt(n) * safe_sig))

    def measured_err(mult: float) -> float:
        tot = 0.0
        for f, sig, bd in zip(factors, sigmas, base_deltas):
            d = bd * mult
            du = np.round(f / d[None, :]) * d[None, :] - f
            tot += float(np.sum((np.asarray(sig, np.float64) ** 2)
                                * np.sum(du * du, axis=0)))
        return float(np.sqrt(tot))

    target = 0.85 * eps_f * vnorm
    lo, hi = 1.0, 1.0
    if measured_err(1.0) < target:
        while measured_err(hi * 2) < target and hi < 64:
            hi *= 2
        hi *= 2
        for _ in range(20):
            mid = np.sqrt(lo * hi)
            if measured_err(mid) < target:
                lo = mid
            else:
                hi = mid
    mult = lo
    mags, signs, deltas, ranks = [], [], [], []
    for f, bd in zip(factors, base_deltas):
        n, r = f.shape
        ranks.append(r)
        delta = bd * mult
        q = np.round(f / delta[None, :])
        mags.append(np.abs(q).astype(np.uint64).ravel(order="F"))
        signs.append((q < 0).astype(np.uint8).ravel(order="F"))
        deltas.append(delta.astype(np.float32))
    return (np.concatenate(mags), np.concatenate(signs),
            np.concatenate(deltas), ranks)


def _dequantize_factors(mag: np.ndarray, sign: np.ndarray,
                        deltas: np.ndarray, ranks: list[int],
                        dims: list[int]) -> list[np.ndarray]:
    factors = []
    off = 0
    doff = 0
    for n, r in zip(dims, ranks):
        q = mag[off:off + n * r].astype(np.float64) \
            * np.where(sign[off:off + n * r].astype(bool), -1.0, 1.0)
        d = deltas[doff:doff + r].astype(np.float64)
        factors.append(q.reshape(n, r, order="F") * d[None, :])
        off += n * r
        doff += r
    return factors


def compress_tthresh(volume: np.ndarray, eps: float = 1e-3,
                     tracker: MemoryTracker | None = None
                     ) -> CompressionResult:
    """TThresh-style compression: full HOSVD + ERROR-DRIVEN BITPLANE
    truncation of the core (Ballester-Ripoll, Lindstrom & Pajarola,
    "TTHRESH: Tensor Compression for Multidimensional Visual Data";
    the codec the reference vendors, compression/src/compression.cpp:
    1-821 ``compressTThresh*``).

    The defining mechanisms are reproduced from the paper:
    1. FULL-rank HOSVD (orthogonal factors) so the core's squared error
       equals the volume's -- rate control happens on coefficients, not
       ranks (unlike :func:`compress_tucker`'s rank truncation);
    2. the core's |coefficients| are scaled to integers and cut at the
       lowest BITPLANE P whose total squared error stays within the
       core share of the ``eps`` budget -- P is found exactly by
       scanning the 64 candidate planes vectorized;
    3. FACTOR MATRICES are per-column quantized with sigma-weighted
       steps and ride the arithmetic coder too (:func:`_quantize_factors`)
       -- total bytes respond to eps across the whole range instead of
       being factor-dominated (the reference's vendored codec encodes
       factors likewise, compression/src/tthresh/encode.hpp).

    Budget split: core gets ``0.7 eps``, factors ``0.3 eps`` (worst-case
    bounds on both sides, so the total relative error stays <= eps by
    the triangle inequality).

    Entropy stage: the ADAPTIVE ARITHMETIC bitplane coder
    (``native/arith.cpp`` -- significance/refinement/sign contexts, the
    core's keyed on its 3D neighbours; the zero runs the paper handles
    with RLE are absorbed by the per-plane significance contexts).
    """
    v = np.asarray(volume, np.float32)
    if tracker:
        tracker.alloc(v.nbytes)
    core = v.astype(np.float64)
    factors = []
    sigmas = []
    for mode in range(3):
        unfold = np.moveaxis(core, mode, 0).reshape(core.shape[mode], -1)
        u, s, _ = np.linalg.svd(unfold, full_matrices=False)
        factors.append(u)
        sigmas.append(s)
        core = _mode_product(core, u.T, mode)
    c = core.ravel()
    amax = float(np.abs(c).max()) or 1.0
    q = np.round(np.abs(c) / amax * float(2 ** 62)).astype(np.uint64)
    sign = (c < 0)
    # exact error per candidate cutoff plane: dropping the low P bits
    # leaves q >> P << P; scan P from 0 up until the error budget breaks
    eps_core = 0.7 * eps
    budget = (eps_core * eps_core) * float(np.sum(c * c))
    scale_back = amax / float(2 ** 62)
    cut = 0
    for p in range(0, 63):
        kept = (q >> np.uint64(p)) << np.uint64(p)
        err = float(np.sum(((q - kept) * scale_back).astype(np.float64)
                           ** 2))
        if err > budget:
            break
        cut = p
    kept = (q >> np.uint64(cut)).astype(np.uint64)
    nbits = max(1, int(kept.max()).bit_length())
    blob = {
        "shape": v.shape,
        "cut": cut,
        "amax": amax,
        "nbits": nbits,
        # arithmetic-coder wire-format version: 2 = 15-bit
        # probabilities; older 12-bit payloads decode to garbage silently
        # without this marker
        "acver": 2,
    }
    vnorm = float(np.sqrt(np.sum(c * c)))
    fm, fs, fd, ranks = _quantize_factors(factors, sigmas, 0.3 * eps, vnorm)
    f_nbits = max(1, int(fm.max()).bit_length())
    # all-zero columns decode to zero regardless of their step:
    # store deltas only for used columns (a packed mask selects them)
    used = []
    off = 0
    for dim, r in zip(v.shape, ranks):
        m2 = fm[off:off + dim * r].reshape(dim, r, order="F")
        used.append(m2.any(axis=0))
        off += dim * r
    used = np.concatenate(used)
    # 3D neighbor contexts pay on the core too: HOSVD energy
    # concentrates at low indices, so significance clusters
    blob["entropy"] = "ac3"
    blob["coeffs"] = arith.encode_planes3d(
        kept.reshape(v.shape), sign.astype(np.uint8).reshape(v.shape), nbits)
    blob["factors_q"] = {
        "nbits": f_nbits,
        "payload": arith.encode_planes(fm, fs, f_nbits),
        "deltas": fd[used],
        "used": np.packbits(used.astype(np.uint8)),
        "ranks": ranks,
    }
    raw = pickle.dumps(blob)
    data = struct.pack("<ii", len(raw), 1) + lz4io.compress(raw)
    rec = decompress_tthresh(data)
    if tracker:
        tracker.free(v.nbytes)
    return CompressionResult(payload=data, compressed_bytes=len(data),
                             raw_bytes=v.nbytes, psnr=_psnr(v, rec))


def decompress_tthresh(data: bytes) -> np.ndarray:
    raw_len, compressed = struct.unpack("<ii", data[:8])
    body = data[8:]
    raw = lz4io.decompress(body, raw_len) if compressed else body
    blob = pickle.loads(raw)
    shape = blob["shape"]
    if blob.get("entropy") != "ac3":
        raise ValueError(
            f"unknown tthresh payload (entropy={blob.get('entropy')!r}); "
            f"this library reads the 3D-context coder's ('ac3')")
    if blob.get("acver") != 2:
        raise ValueError(
            "legacy tthresh payload (12-bit coder); "
            "re-compress with the current library")
    kept, signs_u8 = arith.decode_planes3d(blob["coeffs"], shape,
                                           blob["nbits"])
    sgn = np.where(signs_u8.ravel().astype(bool), -1.0, 1.0)
    mag = (kept.ravel() << np.uint64(blob["cut"])).astype(np.float64) \
        * (blob["amax"] / float(2 ** 62))
    core = (mag * sgn).reshape(shape)
    fq = blob["factors_q"]
    dims = list(shape)
    total = sum(n * r for n, r in zip(dims, fq["ranks"]))
    fm, fs = arith.decode_planes(fq["payload"], total, fq["nbits"])
    n_cols = sum(fq["ranks"])
    used = np.unpackbits(fq["used"])[:n_cols].astype(bool)
    deltas = np.ones(n_cols, np.float32)
    deltas[used] = fq["deltas"]
    factors = _dequantize_factors(fm, fs, deltas, fq["ranks"], dims)
    for mode, f in enumerate(factors):
        core = _mode_product(core, f, mode)
    return core.astype(np.float32)


def compress_quantize(volume: np.ndarray, bits: int = 8,
                      tracker: MemoryTracker | None = None
                      ) -> CompressionResult:
    """Uniform scalar quantization + LZ4."""
    v = np.asarray(volume, np.float32)
    if tracker:
        tracker.alloc(v.nbytes)
    lo = float(v.min())
    hi = float(v.max())
    scale = (hi - lo) or 1.0
    levels = (1 << bits) - 1
    q = np.round((v - lo) / scale * levels)
    dt = np.uint8 if bits <= 8 else np.uint16
    raw = q.astype(dt).tobytes()
    payload = lz4io.compress(raw)
    header = struct.pack("<3i2fB", len(raw), 1, bits, lo, scale,
                         len(v.shape))
    header += struct.pack(f"<{len(v.shape)}i", *v.shape)
    data = header + payload
    rec = decompress_quantize(data)
    if tracker:
        tracker.free(v.nbytes)
    return CompressionResult(payload=data, compressed_bytes=len(data),
                             raw_bytes=v.nbytes, psnr=_psnr(v, rec))


def decompress_quantize(data: bytes) -> np.ndarray:
    raw_len, compressed, bits, lo, scale, ndim = struct.unpack(
        "<3i2fB", data[:21])
    shape = struct.unpack(f"<{ndim}i", data[21:21 + 4 * ndim])
    body = data[21 + 4 * ndim:]
    raw = lz4io.decompress(body, raw_len) if compressed else body
    dt = np.uint8 if bits <= 8 else np.uint16
    levels = (1 << bits) - 1
    q = np.frombuffer(raw, dt).reshape(shape).astype(np.float32)
    return q / levels * scale + lo


# -- CDF 9/7 DWT codec (the cudaCompress pipeline shape) -------------------
# Lifting coefficients of the Cohen-Daubechies-Feauveau 9/7 wavelet
# (the JPEG2000 irreversible filter cudaCompress uses).
_CDF97_A = -1.586134342059924
_CDF97_B = -0.05298011857296141
_CDF97_G = 0.8829110755309332
_CDF97_D = 0.44350685204390013
_CDF97_K = 1.1496043988602418


def _lift_fwd(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """CDF 9/7 forward lifting along axis 0 (even length, symmetric
    extension). Returns (lowpass, highpass), each half length."""
    s = x[0::2].astype(np.float64, copy=True)
    d = x[1::2].astype(np.float64, copy=True)
    d += _CDF97_A * (s + np.concatenate([s[1:], s[-1:]], axis=0))
    s += _CDF97_B * (np.concatenate([d[:1], d[:-1]], axis=0) + d)
    d += _CDF97_G * (s + np.concatenate([s[1:], s[-1:]], axis=0))
    s += _CDF97_D * (np.concatenate([d[:1], d[:-1]], axis=0) + d)
    return s * _CDF97_K, d / _CDF97_K


def _lift_inv(s: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Exact inverse of :func:`_lift_fwd` (reversed lifting steps)."""
    s = s / _CDF97_K
    d = d * _CDF97_K
    s = s - _CDF97_D * (np.concatenate([d[:1], d[:-1]], axis=0) + d)
    d = d - _CDF97_G * (s + np.concatenate([s[1:], s[-1:]], axis=0))
    s = s - _CDF97_B * (np.concatenate([d[:1], d[:-1]], axis=0) + d)
    d = d - _CDF97_A * (s + np.concatenate([s[1:], s[-1:]], axis=0))
    x = np.empty((s.shape[0] * 2,) + s.shape[1:], np.float64)
    x[0::2] = s
    x[1::2] = d
    return x


def _dwt3(v: np.ndarray, levels: int) -> np.ndarray:
    """Multi-level separable 3D CDF 9/7 DWT, lowpass packed into the
    leading half per axis per level (the standard Mallat layout)."""
    out = v.astype(np.float64, copy=True)
    nx, ny, nz = out.shape
    for lv in range(levels):
        sx, sy, sz = nx >> lv, ny >> lv, nz >> lv
        blk = out[:sx, :sy, :sz]
        for ax in range(3):
            m = np.moveaxis(blk, ax, 0)
            s, d = _lift_fwd(m)
            np.moveaxis(blk, ax, 0)[:] = np.concatenate([s, d], axis=0)
        out[:sx, :sy, :sz] = blk
    return out


def _idwt3(c: np.ndarray, levels: int) -> np.ndarray:
    out = c.astype(np.float64, copy=True)
    nx, ny, nz = out.shape
    for lv in range(levels - 1, -1, -1):
        sx, sy, sz = nx >> lv, ny >> lv, nz >> lv
        blk = out[:sx, :sy, :sz]
        for ax in range(2, -1, -1):
            m = np.moveaxis(blk, ax, 0)
            h = m.shape[0] // 2
            np.moveaxis(blk, ax, 0)[:] = _lift_inv(m[:h], m[h:])
        out[:sx, :sy, :sz] = blk
    return out


def _mallat_subbands(shape, levels: int):
    """Subband slices of the packed Mallat layout, coarsest first: the
    LLL approximation band, then per level (coarse to fine) the seven
    detail octants."""
    nx, ny, nz = shape
    bands = [(slice(0, nx >> levels), slice(0, ny >> levels),
              slice(0, nz >> levels))]
    for lv in range(levels, 0, -1):
        hx, hy, hz = nx >> lv, ny >> lv, nz >> lv
        for bx in (0, 1):
            for by in (0, 1):
                for bz in (0, 1):
                    if bx == by == bz == 0:
                        continue
                    bands.append((slice(bx * hx, (bx + 1) * hx),
                                  slice(by * hy, (by + 1) * hy),
                                  slice(bz * hz, (bz + 1) * hz)))
    return bands


def _deadzone_quantize(c: np.ndarray, step: float) -> np.ndarray:
    """JPEG2000-style deadzone quantizer: the zero bin is (-step, step),
    twice the regular bin width -- near-zero detail coefficients (the
    bulk of a smooth field's spectrum) collapse to zero for a fraction
    of their round-quantized rate."""
    return np.sign(c) * np.floor(np.abs(c) / step)


def _deadzone_dequantize(q: np.ndarray, step: float) -> np.ndarray:
    """Midpoint reconstruction: |c| in [|q| step, (|q|+1) step)."""
    return np.where(q == 0.0, 0.0, np.sign(q) * (np.abs(q) + 0.5) * step)


def compress_dwt(volume: np.ndarray, step: float = 3e-3,
                 levels: int = 3,
                 tracker: MemoryTracker | None = None
                 ) -> CompressionResult:
    """cudaCompress-shaped codec: multi-level CDF 9/7 DWT + DEADZONE
    scalar quantization + PER-SUBBAND adaptive arithmetic bitplane
    coding (reference: compression/src/compression.cpp ``compressCUDA*``
    over the vendored cudaCompress DWT/quantizer/coder -- the same
    three-stage pipeline built from scratch; the K-normalized lifting
    makes the transform near-orthonormal, so one global ``step``
    controls distortion across levels).

    The quantizer has the standard deadzone (double-width zero bin), and
    each Mallat subband is coded as its own 3D-context arithmetic pass -- separate adaptive context models AND
    a per-subband plane count (small detail bands with small maxima pay
    only their own bitplanes, and each band's significance statistics
    stop polluting the others'). Requires dimensions divisible by
    2^levels."""
    v = np.asarray(volume, np.float32)
    if tracker:
        tracker.alloc(v.nbytes)
    levels = int(levels)
    for sdim in v.shape:
        if sdim % (1 << levels):
            raise ValueError(
                f"dims {v.shape} not divisible by 2^{levels}")
    coeffs = _dwt3(v, levels)
    band_meta = []
    payloads = []
    for sl in _mallat_subbands(v.shape, levels):
        q = _deadzone_quantize(coeffs[sl], step)
        mag = np.abs(q).astype(np.uint64)
        nb = int(mag.max()).bit_length()
        if nb == 0:
            band_meta.append((0, 0))
            continue
        p = arith.encode_planes3d(mag, (q < 0).astype(np.uint8), nb)
        band_meta.append((nb, len(p)))
        payloads.append(p)
    blob = {"shape": v.shape, "levels": levels, "step": float(step),
            "entropy": "ac-sb3", "bands": band_meta, "acver": 2,
            "coeffs": b"".join(payloads)}
    raw = pickle.dumps(blob)
    data = struct.pack("<i", len(raw)) + raw
    rec = decompress_dwt(data)
    if tracker:
        tracker.free(v.nbytes)
    return CompressionResult(payload=data, compressed_bytes=len(data),
                             raw_bytes=v.nbytes, psnr=_psnr(v, rec))


def decompress_dwt(data: bytes) -> np.ndarray:
    (raw_len,) = struct.unpack("<i", data[:4])
    blob = pickle.loads(data[4:4 + raw_len])
    shape = blob["shape"]
    step = blob["step"]
    if blob["entropy"] != "ac-sb3":
        # older blobs ('ac' whole-volume coding, round-quantized 'lz4')
        # would silently mis-decode under the deadzone semantics and
        # coder wire format -- refuse instead
        raise ValueError(
            f"legacy/unknown dwt payload (entropy="
            f"{blob['entropy']!r}); re-compress with the current "
            f"library")
    if blob.get("acver") != 2:
        # the tthresh decoder's check: another coder version decodes to
        # garbage silently
        raise ValueError(
            f"dwt payload of arithmetic coder version "
            f"{blob.get('acver')!r}, this library reads 2; re-compress "
            f"with the current library")
    coeffs = np.zeros(shape, np.float64)
    body = blob["coeffs"]
    off = 0
    for sl, (nb, ln) in zip(_mallat_subbands(shape, blob["levels"]),
                            blob["bands"]):
        if nb == 0:
            continue
        bshape = [s.stop - s.start for s in sl]
        mag, sg = arith.decode_planes3d(body[off:off + ln], bshape, nb)
        off += ln
        q = mag.astype(np.float64) * np.where(sg.astype(bool), -1.0, 1.0)
        coeffs[sl] = _deadzone_dequantize(q, step).reshape(bshape)
    return _idwt3(coeffs, blob["levels"]).astype(np.float32)


def compression_teaser(volume: np.ndarray, network_bytes: int) -> dict:
    """Size-matched comparison table
    (reference: eval_CompressionTeaser.py:169-241): tune each codec to
    roughly the SRN's byte budget, report ratio + PSNR."""
    results = {}
    for eps in (3e-2, 1e-2, 3e-3):
        r = compress_tthresh(volume, eps)
        results[f"tthresh@{eps:g}"] = {
            "bytes": r.compressed_bytes, "ratio": r.ratio, "psnr": r.psnr}
    for energy in (1e-2, 1e-3, 1e-4):
        r = compress_tucker(volume, energy)
        results[f"tucker@{energy:g}"] = {
            "bytes": r.compressed_bytes, "ratio": r.ratio, "psnr": r.psnr}
    for bits in (4, 8):
        r = compress_quantize(volume, bits)
        results[f"quantize@{bits}bit"] = {
            "bytes": r.compressed_bytes, "ratio": r.ratio, "psnr": r.psnr}
    if all(s % 8 == 0 for s in volume.shape):
        for step in (1e-2, 5e-3, 3e-3, 1e-3):
            r = compress_dwt(volume, step)
            results[f"dwt@{step:g}"] = {
                "bytes": r.compressed_bytes, "ratio": r.ratio,
                "psnr": r.psnr}
    results["network"] = {"bytes": network_bytes,
                          "ratio": volume.nbytes / max(network_bytes, 1)}
    return results


def compress_dwt_chunked(volume: np.ndarray, step: float = 3e-3,
                         brick: int = 64, levels: int = 3,
                         tracker: MemoryTracker | None = None
                         ) -> CompressionResult:
    """Chunked (per-brick) DWT codec -- the cudaCompress INTERACTIVE
    decompression structure (reference: compression/src/compression.cpp
    :821 area + compression_cu.cu: the GPU codec compresses bricks
    independently so the renderer can decompress only the bricks a view
    touches, streaming into mipmap surfaces). Each ``brick``^3 block is
    an independent :func:`compress_dwt` payload addressable by
    :func:`decompress_dwt_brick` without touching the rest."""
    v = np.asarray(volume, np.float32)
    if tracker:
        tracker.alloc(v.nbytes)
    for sdim in v.shape:
        if sdim % brick:
            raise ValueError(f"dims {v.shape} not divisible by "
                             f"brick={brick}")
    nb = tuple(sdim // brick for sdim in v.shape)
    payloads = []
    for bx in range(nb[0]):
        for by in range(nb[1]):
            for bz in range(nb[2]):
                blk = v[bx * brick:(bx + 1) * brick,
                        by * brick:(by + 1) * brick,
                        bz * brick:(bz + 1) * brick]
                r = compress_dwt(blk, step=step, levels=levels)
                payloads.append(r.payload)
    index = np.cumsum([0] + [len(p) for p in payloads]).astype(np.int64)
    head = struct.pack("<4i", brick, *nb)
    head += index.tobytes()
    data = head + b"".join(payloads)
    rec = decompress_dwt_chunked(data)
    if tracker:
        tracker.free(v.nbytes)
    return CompressionResult(payload=data, compressed_bytes=len(data),
                             raw_bytes=v.nbytes, psnr=_psnr(v, rec))


def _dwt_chunk_header(data: bytes):
    brick, nx, ny, nz = struct.unpack("<4i", data[:16])
    n = nx * ny * nz
    index = np.frombuffer(data[16:16 + 8 * (n + 1)], np.int64)
    body = data[16 + 8 * (n + 1):]
    return brick, (nx, ny, nz), index, body


def decompress_dwt_brick(data: bytes, bx: int, by: int, bz: int
                         ) -> np.ndarray:
    """Decode ONE brick of a chunked payload (interactive
    decompression: cost is proportional to the brick, not the
    volume)."""
    brick, nb, index, body = _dwt_chunk_header(data)
    i = (bx * nb[1] + by) * nb[2] + bz
    return decompress_dwt(body[index[i]:index[i + 1]])


def decompress_dwt_chunked(data: bytes) -> np.ndarray:
    brick, nb, index, body = _dwt_chunk_header(data)
    out = np.empty((nb[0] * brick, nb[1] * brick, nb[2] * brick),
                   np.float32)
    i = 0
    for bx in range(nb[0]):
        for by in range(nb[1]):
            for bz in range(nb[2]):
                out[bx * brick:(bx + 1) * brick,
                    by * brick:(by + 1) * brick,
                    bz * brick:(bz + 1) * brick] = \
                    decompress_dwt(body[index[i]:index[i + 1]])
                i += 1
    return out
