"""``.volnet`` files: the reference renderer's deployment format for scene
networks.

Counterpart of ``fvsrn_tpu/models/export.py``, field for field and byte
for byte: little-endian; SceneNetwork v2, InputParametrization v3,
OutputParametrization v1, Layer v2, LatentGrid v1 and
LatentGridTimeAndEnsemble v1. Weights and the Fourier matrix are stored
as float16; latent grids (C, Z, Y, X) as float32 (``ENCODING_FLOAT``) or
one byte a value with per-channel offset and scale (``BYTE_LINEAR``:
min and range; ``BYTE_GAUSSIAN``: mean and standard deviation through the
normal CDF). What the format keeps of the network, as the JAX writer
keeps it: ``hasTime`` is written False, time Fourier features and latent
vectors are not stored, and a static grid is stored as one time keyframe,
which reads back as a static grid (one time keyframe, no ensemble).
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from .latent import LatentSpace
from .srn import InputParametrization, Layer, SceneRepresentationNetwork

_INPUT_VERSION = 3
_OUTPUT_VERSION = 1
_LAYER_VERSION = 2
_GRID_VERSION = 1
_TIME_ENSEMBLE_VERSION = 1
_NETWORK_VERSION = 2

ENCODING_FLOAT = 0
ENCODING_BYTE_LINEAR = 1
ENCODING_BYTE_GAUSSIAN = 2

_ACTIVATION_NAMES = ("ReLU", "Sine", "Snake", "SnakeAlt", "Sigmoid",
                     "None")
_OUTPUT_MODES = ("density", "density:direct", "rgbo", "rgbo:direct",
                 "rgbo:exp")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _write_string(out, s: str):
    b = s.encode()
    out.write(struct.pack("<i", len(b)))
    out.write(b)


def _read_string(inp) -> str:
    n, = struct.unpack("<i", inp.read(4))
    return inp.read(n).decode()


def save_volnet(net: SceneRepresentationNetwork, path_or_stream,
                box_min=(-0.5, -0.5, -0.5), box_size=(1.0, 1.0, 1.0),
                grid_encoding: int = ENCODING_FLOAT):
    """Write ``net`` and its box to a path or a binary stream."""
    own = isinstance(path_or_stream, str)
    out = open(path_or_stream, "wb") if own else path_or_stream
    try:
        out.write(struct.pack("<i", _NETWORK_VERSION))
        _save_input(net.input, out)
        _save_output(net.output_mode, out)
        out.write(struct.pack("<i", len(net.layers)))
        for layer in net.layers:
            _save_layer(layer, out)
        out.write(struct.pack("<3f", *(float(v) for v in box_min)))
        out.write(struct.pack("<3f", *(float(v) for v in box_size)))
        lat = net.latent
        has_grid = any(g is not None for g in (lat.static_grid,
                                               lat.time_grid,
                                               lat.ensemble_grid))
        out.write(b"\x01" if has_grid else b"\x00")
        if has_grid:
            _save_time_ensemble(lat, out, grid_encoding)
    finally:
        if own:
            out.close()


def load_volnet(path_or_stream) -> tuple[SceneRepresentationNetwork,
                                         np.ndarray, np.ndarray]:
    """(network on the CPU, box_min, box_size) of a ``.volnet``."""
    own = isinstance(path_or_stream, str)
    inp = open(path_or_stream, "rb") if own else path_or_stream
    try:
        version, = struct.unpack("<i", inp.read(4))
        if version > _NETWORK_VERSION:
            raise ValueError(f"unknown SceneNetwork version {version}")
        input_param = _load_input(inp)
        output_mode = _load_output(inp)
        num_layers, = struct.unpack("<i", inp.read(4))
        layers = [_load_layer(inp) for _ in range(num_layers)]
        box_min = np.asarray(struct.unpack("<3f", inp.read(12)), np.float32)
        box_size = np.asarray(struct.unpack("<3f", inp.read(12)),
                              np.float32)
        latent = LatentSpace()
        if version >= 2 and inp.read(1) != b"\x00":
            latent = _load_time_ensemble(inp)
        net = SceneRepresentationNetwork(input_param, layers, latent,
                                         output_mode=output_mode)
        return net, box_min, box_size
    finally:
        if own:
            inp.close()


def _save_input(p: InputParametrization, out):
    out.write(struct.pack("<i", _INPUT_VERSION))
    out.write(struct.pack("<?", False))   # hasTime: grids carry the time
    out.write(struct.pack("<?", p.has_direction))
    m = p.fourier_matrix
    f = 0 if m is None else m.shape[0]
    out.write(struct.pack("<i", f))
    out.write(struct.pack("<?", m is not None and m.shape[1] == 6))
    if f > 0:
        out.write(_np(m).astype(np.float16).tobytes())


def _load_input(inp) -> InputParametrization:
    version, = struct.unpack("<i", inp.read(4))
    if version != _INPUT_VERSION:
        raise ValueError(f"only InputParametrization v{_INPUT_VERSION} "
                         f"supported, got {version}")
    struct.unpack("<?", inp.read(1))                  # hasTime
    has_direction, = struct.unpack("<?", inp.read(1))
    f, = struct.unpack("<i", inp.read(4))
    use_dir_fourier, = struct.unpack("<?", inp.read(1))
    c = 6 if use_dir_fourier else 3
    matrix = None
    if f > 0:
        matrix = torch.from_numpy(np.frombuffer(
            inp.read(2 * f * c), np.float16).reshape(f, c).astype(
                np.float32))
    return InputParametrization(
        fourier_matrix=matrix, has_direction=has_direction,
        disable_direction_in_fourier=not use_dir_fourier)


def _save_output(mode: str, out):
    out.write(struct.pack("<i", _OUTPUT_VERSION))
    _write_string(out, mode)


def _load_output(inp) -> str:
    version, = struct.unpack("<i", inp.read(4))
    if version != _OUTPUT_VERSION:
        raise ValueError(f"unknown OutputParametrization v{version}")
    mode = _read_string(inp)
    if mode not in _OUTPUT_MODES:
        raise ValueError(f"unknown output mode {mode}")
    return mode


def _save_layer(layer: Layer, out):
    out.write(struct.pack("<i", _LAYER_VERSION))
    w = _np(layer.weight).astype(np.float16)          # (out, in)
    rows, cols = w.shape
    out.write(struct.pack("<ii", rows, cols))
    out.write(w.tobytes())
    out.write(_np(layer.bias).astype(np.float16).tobytes())
    _write_string(out, layer.activation
                  if layer.activation in _ACTIVATION_NAMES else "None")
    out.write(struct.pack("<f", layer.activation_param))


def _load_layer(inp) -> Layer:
    version, = struct.unpack("<i", inp.read(4))
    if version not in (1, 2):
        raise ValueError(f"unknown Layer version {version}")
    rows, cols = struct.unpack("<ii", inp.read(8))
    w = np.frombuffer(inp.read(2 * rows * cols),
                      np.float16).reshape(rows, cols).astype(np.float32)
    b = np.frombuffer(inp.read(2 * rows), np.float16).astype(np.float32)
    act = _read_string(inp)
    param = 1.0
    if version == 2:
        param, = struct.unpack("<f", inp.read(4))
    return Layer(torch.from_numpy(w), torch.from_numpy(b), activation=act,
                 activation_param=param)


def _encode_grid(grid: np.ndarray, encoding: int):
    """(payload bytes, offset, scale) of a (C, Z, Y, X) float32 grid."""
    c = grid.shape[0]
    if encoding == ENCODING_FLOAT:
        return grid.astype(np.float32).tobytes(), None, None
    flat = grid.reshape(c, -1)
    if encoding == ENCODING_BYTE_LINEAR:
        lo = flat.min(axis=1)
        hi = flat.max(axis=1)
        scale = np.where(hi > lo, hi - lo, 1.0)
        q = np.clip((flat - lo[:, None]) / scale[:, None], 0, 1)
        payload = np.round(q * 255).astype(np.uint8).tobytes()
        return payload, lo.astype(np.float32), scale.astype(np.float32)
    if encoding == ENCODING_BYTE_GAUSSIAN:
        from scipy.stats import norm
        mu = flat.mean(axis=1)
        std = np.maximum(flat.std(axis=1), 1e-8)
        q = norm.cdf((flat - mu[:, None]) / std[:, None])
        payload = np.clip(np.round(q * 255), 0, 255).astype(
            np.uint8).tobytes()
        return payload, mu.astype(np.float32), std.astype(np.float32)
    raise ValueError(f"unknown encoding {encoding}")


def _decode_grid(payload: bytes, encoding: int, shape, offset,
                 scale) -> np.ndarray:
    if encoding == ENCODING_FLOAT:
        return np.frombuffer(payload, np.float32).reshape(shape).copy()
    q = np.frombuffer(payload, np.uint8).reshape(shape[0], -1) / 255.0
    if encoding == ENCODING_BYTE_LINEAR:
        flat = q * scale[:, None] + offset[:, None]
    elif encoding == ENCODING_BYTE_GAUSSIAN:
        from scipy.stats import norm
        flat = (norm.ppf(np.clip(q, 1e-6, 1 - 1e-6)) * scale[:, None]
                + offset[:, None])
    else:
        raise ValueError(f"unknown encoding {encoding}")
    return flat.reshape(shape).astype(np.float32)


def _save_latent_grid(grid: np.ndarray, out, encoding: int):
    out.write(struct.pack("<i", _GRID_VERSION))
    out.write(struct.pack("<i", encoding))
    out.write(struct.pack("<4i", *grid.shape))
    payload, offset, scale = _encode_grid(grid.astype(np.float32), encoding)
    out.write(payload)
    if encoding != ENCODING_FLOAT:
        out.write(offset.tobytes())
        out.write(scale.tobytes())


def _load_latent_grid(inp) -> np.ndarray:
    version, = struct.unpack("<i", inp.read(4))
    if version != _GRID_VERSION:
        raise ValueError(f"unknown LatentGrid version {version}")
    encoding, = struct.unpack("<i", inp.read(4))
    shape = struct.unpack("<4i", inp.read(16))
    n = int(np.prod(shape))
    payload = inp.read((4 if encoding == ENCODING_FLOAT else 1) * n)
    offset = scale = None
    if encoding != ENCODING_FLOAT:
        offset = np.frombuffer(inp.read(4 * shape[0]), np.float32)
        scale = np.frombuffer(inp.read(4 * shape[0]), np.float32)
    return _decode_grid(payload, encoding, shape, offset, scale)


def _save_time_ensemble(lat: LatentSpace, out, encoding: int):
    out.write(struct.pack("<i", _TIME_ENSEMBLE_VERSION))

    def frames(g: Optional[torch.Tensor]) -> list:
        return [] if g is None else list(_np(g))

    if lat.time_dependent:
        time_grids = frames(lat.time_grid)
        ens_grids = frames(lat.ensemble_grid)
    else:
        time_grids = ([_np(lat.static_grid)] if lat.static_grid is not None
                      else [])
        ens_grids = []
    # timeMin, timeNum, timeStep, ensembleMin, ensembleNum
    out.write(struct.pack("<5i", 0, len(time_grids), 1, 0, len(ens_grids)))
    for g in time_grids + ens_grids:
        _save_latent_grid(g, out, encoding)


def _load_time_ensemble(inp) -> LatentSpace:
    version, = struct.unpack("<i", inp.read(4))
    if version > _TIME_ENSEMBLE_VERSION:
        raise ValueError(f"unknown LatentGridTimeAndEnsemble v{version}")
    _, tnum, _, _, enum = struct.unpack("<5i", inp.read(20))
    time_grids = [_load_latent_grid(inp) for _ in range(tnum)]
    ens_grids = [_load_latent_grid(inp) for _ in range(enum)]
    if tnum == 1 and enum == 0:
        return LatentSpace(static_grid=torch.from_numpy(time_grids[0]))

    def stack(grids):
        return torch.from_numpy(np.stack(grids)) if grids else None

    return LatentSpace(time_grid=stack(time_grids),
                       ensemble_grid=stack(ens_grids), time_dependent=True)
