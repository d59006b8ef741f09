"""Volume container: multi-feature voxel datasets with .cvol IO.

Counterpart of ``fvsrn_tpu/volume/volume.py``, host NumPy as there:
``Volume`` / ``Feature`` / ``MipmapLevel``, multi-feature,
multi-channel voxel grids with mipmaps, the binary ``.cvol`` format
(version-1 multi-feature and legacy single-feature), LZ4-compressed
payloads through the port's own codec (``lz4io``), tensor conversion,
synthetic and implicit datasets and a density histogram.

File formats:
- v1: 64B header [magic 'CVOL' | version i32 | worldX/Y/Z f32 |
  numFeatures i32 | flags i32 | 4B pad]; per feature [nameLen i32 | name |
  sizeX/Y/Z u64 | channels i32 | dtype i32 | payload]. Payload memory
  order: channels fastest, then X, Y, Z slowest -> numpy (Z, Y, X, C)
  row-major.
- legacy: magic 'cvol', sizes u64*3, voxel size f64*3, dtype u32,
  compressed-bool byte, 7B pad, X-fastest payload; world size = size x
  voxel size.

Compression: the lz4cpp stream framing, per chunk an i32 compressed size
followed by one LZ4 block, the raw size implicit. Writes compress
independent 64 KB chunks (a valid streaming special case); reads decode
into contiguous memory, so chunks that back-reference the previous
chunk's output (dictionary continuation) decode too
(``lz4io.decompress_into``), and fall back to the round-1 framing
([i32 rawLen | i32 compLen | block]*) of older files. The files are
byte-identical to the JAX package's, compressed or not.
"""
from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from . import lz4io

MAGIC_V1 = b"CVOL"
MAGIC_LEGACY = b"cvol"
FLAG_COMPRESSED = 1
MAX_CHUNK = 1 << 20    # 1MB raw chunks (round-1 framing, read-only now)
LZ4CPP_CHUNK = 1 << 16  # 64KB raw chunks for the lz4cpp-framed writes

DTYPE_UCHAR = 0
DTYPE_USHORT = 1
DTYPE_FLOAT = 2
_NUMPY_DTYPES = {DTYPE_UCHAR: np.uint8, DTYPE_USHORT: np.uint16,
                 DTYPE_FLOAT: np.float32}
_DTYPE_CODES = {np.dtype(np.uint8): DTYPE_UCHAR,
                np.dtype(np.uint16): DTYPE_USHORT,
                np.dtype(np.float32): DTYPE_FLOAT}
_DTYPE_MAX = {DTYPE_UCHAR: 0xFF, DTYPE_USHORT: 0xFFFF, DTYPE_FLOAT: 1}


@dataclass
class MipmapLevel:
    """One resolution level; data (Z, Y, X, C) in file memory order
    (reference: volume.h:95-170 ``MipmapLevel``)."""
    data: np.ndarray

    @property
    def size_x(self) -> int:
        return self.data.shape[2]

    @property
    def size_y(self) -> int:
        return self.data.shape[1]

    @property
    def size_z(self) -> int:
        return self.data.shape[0]

    @property
    def channels(self) -> int:
        return self.data.shape[3]

    def to_tensor(self) -> np.ndarray:
        """(C, X, Y, Z) float copy (reference: volume.h:163
        ``toTensor``: shape C*X*Y*Z). uchar/ushort are normalized to
        [0, 1] like the reference's texture path."""
        t = np.transpose(self.data, (3, 2, 1, 0)).astype(np.float32)
        code = _DTYPE_CODES[self.data.dtype]
        if code != DTYPE_FLOAT:
            t = t / _DTYPE_MAX[code]
        return t

    def from_tensor(self, t: np.ndarray):
        """Set from (C, X, Y, Z) (reference: volume.h:168)."""
        if t.shape != (self.channels, self.size_x, self.size_y,
                       self.size_z):
            raise ValueError(f"shape mismatch: {t.shape}")
        code = _DTYPE_CODES[self.data.dtype]
        v = np.transpose(t, (3, 2, 1, 0))
        if code != DTYPE_FLOAT:
            v = np.clip(v, 0, 1) * _DTYPE_MAX[code]
        self.data = np.ascontiguousarray(v.astype(self.data.dtype))


@dataclass
class Feature:
    """Named feature channel group with mipmaps
    (reference: volume.h:190-280 ``Feature``)."""
    name: str
    levels: list = field(default_factory=list)

    @property
    def dtype_code(self) -> int:
        return _DTYPE_CODES[self.levels[0].data.dtype]

    @property
    def channels(self) -> int:
        return self.levels[0].channels

    def get_level(self, level: int) -> Optional[MipmapLevel]:
        if level < len(self.levels):
            return self.levels[level]
        return None

    def create_mipmap_level(self, level: int, filter: str = "average"):
        """Level L has size size0 // (L+1) (the reference's convention,
        volume.cpp ``mipmapCheckOrCreate``): 'average' = adaptive mean
        pooling, 'halton' = jittered point sampling."""
        if level < len(self.levels) and self.levels[level] is not None:
            return
        base = self.levels[0].data
        z0, y0, x0, c = base.shape
        nz = max(1, z0 // (level + 1))
        ny = max(1, y0 // (level + 1))
        nx = max(1, x0 // (level + 1))
        while len(self.levels) <= level:
            self.levels.append(None)
        if filter == "average":
            out = _adaptive_avg_pool3d(base.astype(np.float64),
                                       (nz, ny, nx))
            out = out.astype(base.dtype) if base.dtype != np.float32 \
                else out.astype(np.float32)
        elif filter == "halton":
            rng = np.random.default_rng(level)
            zi = np.minimum((np.arange(nz) + rng.random(nz))
                            * (z0 / nz), z0 - 1).astype(int)
            yi = np.minimum((np.arange(ny) + rng.random(ny))
                            * (y0 / ny), y0 - 1).astype(int)
            xi = np.minimum((np.arange(nx) + rng.random(nx))
                            * (x0 / nx), x0 - 1).astype(int)
            out = base[np.ix_(zi, yi, xi)]
        else:
            raise ValueError(f"unknown mipmap filter {filter}")
        self.levels[level] = MipmapLevel(np.ascontiguousarray(out))

    def delete_all_mipmap_levels(self):
        self.levels = self.levels[:1]


def _adaptive_avg_pool3d(data: np.ndarray, out_shape) -> np.ndarray:
    nz, ny, nx = out_shape
    z0, y0, x0, c = data.shape

    def pool_axis(a, axis, n_out):
        n_in = a.shape[axis]
        bounds = [(int(np.floor(i * n_in / n_out)),
                   max(int(np.ceil((i + 1) * n_in / n_out)),
                       int(np.floor(i * n_in / n_out)) + 1))
                  for i in range(n_out)]
        slices = [a.take(range(lo, hi), axis=axis).mean(axis=axis,
                                                        keepdims=True)
                  for lo, hi in bounds]
        return np.concatenate(slices, axis=axis)

    out = pool_axis(data, 0, nz)
    out = pool_axis(out, 1, ny)
    out = pool_axis(out, 2, nx)
    return out


class Volume:
    """Multi-feature voxel volume (reference: volume.h:80-470)."""

    def __init__(self, world_size=(1.0, 1.0, 1.0)):
        self.world_size = tuple(float(v) for v in world_size)
        self.features: list[Feature] = []

    # -- construction ----------------------------------------------------
    def add_feature(self, name: str, data: np.ndarray) -> Feature:
        """data: (Z, Y, X, C) or (X, Y, Z) single-channel convenience."""
        if data.ndim == 3:
            data = np.transpose(data, (2, 1, 0))[..., None]
        if data.dtype not in _DTYPE_CODES:
            data = data.astype(np.float32)
        f = Feature(name=name,
                    levels=[MipmapLevel(np.ascontiguousarray(data))])
        self.features.append(f)
        return f

    def get_feature(self, name_or_index) -> Feature:
        if isinstance(name_or_index, int):
            return self.features[name_or_index]
        for f in self.features:
            if f.name == name_or_index:
                return f
        raise KeyError(name_or_index)

    @property
    def density(self) -> np.ndarray:
        """First feature, level 0, as (X, Y, Z) float (the renderer's
        default input)."""
        t = self.features[0].levels[0].to_tensor()
        return t[0]

    @classmethod
    def create_implicit_dataset(cls, resolution: int, equation: str, *,
                                device="cuda", **params) -> "Volume":
        """The equation voxelized at ``resolution``^3 on ``device``
        (:func:`implicit.create_implicit_grid`), kept on the host as one
        float32 feature "density"."""
        from .implicit import create_implicit_grid
        g = create_implicit_grid(resolution, equation, device=device,
                                 **params).cpu().numpy()
        v = cls(world_size=(1.0, 1.0, 1.0))
        v.add_feature("density", g)
        return v

    @classmethod
    def create_synthetic_dataset(cls, resolution: int, box_min: float,
                                 box_max: float,
                                 fn: Callable) -> "Volume":
        coords = box_min + np.arange(resolution) * (box_max - box_min) \
            / (resolution - 1)
        x = coords[:, None, None]
        y = coords[None, :, None]
        z = coords[None, None, :]
        g = np.asarray(fn(x, y, z), np.float32)
        g = np.broadcast_to(g, (resolution,) * 3)
        v = cls()
        v.add_feature("density", g)
        return v

    # -- histogram -------------------------------------------------------
    def histogram(self, bins: int = 512, feature: int = 0):
        """512-bin density histogram (reference: renderer_histogram.cuh:
        9-21 ``VolumeHistogram``; volume_interpolation_grid.h:159-167).
        Returns (counts, min_density, max_density)."""
        d = self.features[feature].levels[0].to_tensor()[0]
        lo, hi = float(d.min()), float(d.max())
        counts, _ = np.histogram(d, bins=bins, range=(lo, hi if hi > lo
                                                      else lo + 1))
        return counts, lo, hi

    # -- IO --------------------------------------------------------------
    def save(self, filename: str, compression: int = 0):
        """(reference: volume.cpp:626-668 ``save``)"""
        use_comp = compression > 0
        with open(filename, "wb") as s:
            s.write(MAGIC_V1)
            s.write(struct.pack("<i", 1))
            s.write(struct.pack("<3f", *self.world_size))
            s.write(struct.pack("<i", len(self.features)))
            s.write(struct.pack("<i", FLAG_COMPRESSED if use_comp else 0))
            s.write(b"\x00" * 4)
            for f in self.features:
                lvl = f.levels[0]
                name = f.name.encode()
                s.write(struct.pack("<i", len(name)))
                s.write(name)
                s.write(struct.pack("<3Q", lvl.size_x, lvl.size_y,
                                    lvl.size_z))
                s.write(struct.pack("<i", lvl.channels))
                s.write(struct.pack("<i", f.dtype_code))
                payload = lvl.data.tobytes()
                if use_comp:
                    _write_lz4_chunks(s, payload)
                else:
                    s.write(payload)

    @classmethod
    def load(cls, filename: str) -> "Volume":
        """(reference: volume.cpp:696-800 loading ctor, both formats)"""
        with open(filename, "rb") as s:
            magic = s.read(4)
            if magic == MAGIC_V1:
                return cls._load_v1(s)
            if magic == MAGIC_LEGACY:
                return cls._load_legacy(s)
            raise ValueError(f"unrecognized magic {magic!r}")

    @classmethod
    def _load_v1(cls, s) -> "Volume":
        version, = struct.unpack("<i", s.read(4))
        if version != 1:
            raise ValueError(f"unsupported .cvol version {version}")
        wx, wy, wz = struct.unpack("<3f", s.read(12))
        num_features, = struct.unpack("<i", s.read(4))
        flags, = struct.unpack("<i", s.read(4))
        s.read(4)
        compressed = bool(flags & FLAG_COMPRESSED)
        v = cls(world_size=(wx, wy, wz))
        for _ in range(num_features):
            name_len, = struct.unpack("<i", s.read(4))
            name = s.read(name_len).decode()
            sx, sy, sz = struct.unpack("<3Q", s.read(24))
            channels, = struct.unpack("<i", s.read(4))
            dtype_code, = struct.unpack("<i", s.read(4))
            dt = _NUMPY_DTYPES[dtype_code]
            nbytes = sx * sy * sz * channels * np.dtype(dt).itemsize
            payload = _read_lz4_chunks(s, nbytes) if compressed \
                else s.read(nbytes)
            data = np.frombuffer(payload, dtype=dt).reshape(
                sz, sy, sx, channels)
            v.features.append(Feature(
                name=name, levels=[MipmapLevel(data.copy())]))
        return v

    @classmethod
    def _load_legacy(cls, s) -> "Volume":
        sx, sy, sz = struct.unpack("<3Q", s.read(24))
        vx, vy, vz = struct.unpack("<3d", s.read(24))
        dtype_code, = struct.unpack("<I", s.read(4))
        compressed = s.read(1) != b"\x00"
        s.read(7)
        dt = _NUMPY_DTYPES[dtype_code]
        nbytes = sx * sy * sz * np.dtype(dt).itemsize
        payload = _read_lz4_chunks(s, nbytes) if compressed \
            else s.read(nbytes)
        # legacy payload: X fastest, Z slowest -> (Z, Y, X)
        data = np.frombuffer(payload, dtype=dt).reshape(sz, sy, sx)
        v = cls(world_size=(sx * vx, sy * vy, sz * vz))
        v.features.append(Feature(
            name="density", levels=[MipmapLevel(data[..., None].copy())]))
        return v

    def estimate_memory(self) -> int:
        return sum(l.data.nbytes for f in self.features
                   for l in f.levels if l is not None)


def _write_lz4_chunks(s, payload: bytes):
    """Write the lz4cpp stream framing the reference uses
    (reverse-engineered from volume.cpp:335-380: per chunk an i32
    compressed size followed by one LZ4 block; the raw size is implicit
    in the block). Chunks are 64 KB raw -- the LZ4 window size -- and
    compressed independently, which is a valid special case of the
    reference's streaming compression (LZ4_compress_HC_continue), so a
    streaming decoder reads them unchanged."""
    for off in range(0, len(payload), LZ4CPP_CHUNK):
        raw = payload[off:off + LZ4CPP_CHUNK]
        comp = lz4io.compress(raw)
        s.write(struct.pack("<i", len(comp)))
        s.write(comp)


def _read_lz4cpp_chunks(s, total: int) -> bytes:
    """Read lz4cpp-framed chunks ([i32 compSize | LZ4 block]*) into one
    contiguous buffer. Streamed chunks may back-reference the previous
    chunk's output (dictionary continuation), which contiguous decoding
    supports natively (lz4io.decompress_into)."""
    out = np.empty(total, np.uint8)
    got = 0
    while got < total:
        hdr = s.read(4)
        if len(hdr) < 4:
            raise RuntimeError("truncated lz4cpp chunk stream")
        comp_len, = struct.unpack("<i", hdr)
        if not 0 < comp_len <= (1 << 24):
            raise RuntimeError(f"implausible lz4cpp chunk size {comp_len}")
        comp = s.read(comp_len)
        if len(comp) < comp_len:
            raise RuntimeError("truncated lz4cpp chunk")
        n = lz4io.decompress_into(comp, out, got)
        if n <= 0:
            raise RuntimeError("corrupt lz4cpp chunk")
        got += n
    if got != total:
        raise RuntimeError(f"lz4cpp stream produced {got} of {total} B")
    return out.tobytes()


def _read_lz4_chunks(s, total: int) -> bytes:
    """Read a compressed payload: the reference's lz4cpp framing first,
    falling back to this framework's round-1 framing
    ([i32 rawLen | i32 compLen | LZ4 block]*) for files written before
    the interop change."""
    pos = s.tell()
    try:
        return _read_lz4cpp_chunks(s, total)
    except RuntimeError:
        s.seek(pos)
    out = io.BytesIO()
    got = 0
    while got < total:
        raw_len, comp_len = struct.unpack("<ii", s.read(8))
        comp = s.read(comp_len)
        out.write(lz4io.decompress(comp, raw_len))
        got += raw_len
    return out.getvalue()
