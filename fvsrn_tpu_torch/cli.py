"""Volume converter: .dat/.xyz/.cvol -> .cvol.

Counterpart of ``fvsrn_tpu/cli.py``, on the port's ``volume.Volume``
(host NumPy; no card is needed):

- ``.dat``: a text descriptor with ``ObjectFileName:``, ``Resolution: X Y
  Z``, ``SliceThickness: x y z`` and ``Format: UCHAR|USHORT|BYTE|FLOAT``
  pointing at a raw payload (X fastest); the world size is the extent
  (resolution times slice thickness) over its largest axis.
- ``.xyz``: a binary header [u32 sizeX/Y/Z, f64 voxelSize x/y/z] followed
  by float32 data (z fastest, then y, x slowest); the stored voxel sizes
  are ignored and the world size is normalized so the largest axis spans
  1.

Usage: python -m fvsrn_tpu_torch.cli input.{dat,xyz,cvol} output.cvol
       [--compression N] [--mipmaps L]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .volume.volume import Feature, MipmapLevel, Volume

_DAT_FORMATS = {"UCHAR": np.uint8, "BYTE": np.uint8,
                "USHORT": np.uint16, "FLOAT": np.float32}


def load_dat(path: str) -> Volume:
    """A ``.dat`` descriptor and its raw payload as a one-feature
    volume."""
    object_file = ""
    resolution = None
    thickness = (1.0, 1.0, 1.0)
    fmt = ""
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tok = parts[0]
            if tok == "ObjectFileName:":
                object_file = parts[1]
            elif tok == "Resolution:":
                resolution = tuple(int(v) for v in parts[1:4])
            elif tok == "SliceThickness:":
                thickness = tuple(float(v) for v in parts[1:4])
            elif tok == "Format:":
                fmt = parts[1]
    if not object_file or resolution is None or fmt not in _DAT_FORMATS:
        raise ValueError(
            ".dat must provide ObjectFileName, Resolution and a known "
            "Format")
    raw_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                            object_file)
    sx, sy, sz = resolution
    data = np.fromfile(raw_path, dtype=_DAT_FORMATS[fmt],
                       count=sx * sy * sz)
    data = data.reshape(sz, sy, sx)  # X fastest in the file
    ext = np.asarray(resolution, np.float64) * np.asarray(thickness)
    world = ext / ext.max()
    v = Volume(world_size=tuple(world))
    v.features.append(_feature_from_zyx("density", data))
    return v


def load_xyz(path: str) -> Volume:
    """An ``.xyz`` file as a one-feature volume."""
    with open(path, "rb") as f:
        header = np.frombuffer(f.read(12), np.uint32)
        sx, sy, sz = (int(v) for v in header)
        f.read(24)  # the stored voxel sizes are not read
        data = np.fromfile(f, np.float32, count=sx * sy * sz)
    # file order: z fastest, then y, x slowest
    data_zyx = np.transpose(data.reshape(sx, sy, sz), (2, 1, 0))
    max_size = max(sx, sy, sz)
    world = (sx / max_size, sy / max_size, sz / max_size)
    v = Volume(world_size=world)
    v.features.append(_feature_from_zyx("density", data_zyx))
    return v


def _feature_from_zyx(name: str, data_zyx: np.ndarray) -> Feature:
    return Feature(name=name, levels=[
        MipmapLevel(np.ascontiguousarray(data_zyx[..., None]))])


def load_any(path: str) -> Volume:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".dat":
        return load_dat(path)
    if ext == ".xyz":
        return load_xyz(path)
    if ext == ".cvol":
        return Volume.load(path)
    raise ValueError(f"unknown input extension {ext}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert volumes to .cvol")
    p.add_argument("input", help=".dat/.xyz/.cvol input")
    p.add_argument("output", help=".cvol output")
    p.add_argument("--compression", type=int, default=0,
                   help="0 = none, >0 = LZ4 (64 KB chunks)")
    p.add_argument("--mipmaps", type=int, default=0,
                   help="create this many mipmap levels")
    args = p.parse_args(argv)
    v = load_any(args.input)
    for f in v.features:
        for level in range(1, args.mipmaps + 1):
            f.create_mipmap_level(level)
    v.save(args.output, compression=args.compression)
    lvl = v.features[0].levels[0]
    print(f"wrote {args.output}: {len(v.features)} feature(s), "
          f"{lvl.size_x}x{lvl.size_y}x{lvl.size_z}, "
          f"world={v.world_size}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
