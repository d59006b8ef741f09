"""Port parity, the volume converter (``fvsrn_tpu_torch/cli.py`` against
``fvsrn_tpu/cli.py``): ``.dat`` files in every format and ``.xyz`` files
load to the same arrays and world sizes bit for bit, and the ``.cvol``
each package's ``main`` writes is byte-identical, raw and LZ4-compressed,
with two mipmap levels; the JAX package's own checks of both loaders
(tests/test_cli_sh.py) on the port."""
import struct

import numpy as np
import pytest

from fvsrn_tpu.cli import load_dat as jload_dat
from fvsrn_tpu.cli import load_xyz as jload_xyz
from fvsrn_tpu.cli import main as jmain
from fvsrn_tpu.volume.volume import Volume as JVolume
from fvsrn_tpu_torch.cli import load_any, load_dat, load_xyz, main
from fvsrn_tpu_torch.volume.volume import Volume

FORMATS = {"UCHAR": np.uint8, "BYTE": np.uint8, "USHORT": np.uint16,
           "FLOAT": np.float32}


def write_dat(tmp_path, rng, fmt, res=(6, 5, 4), thickness=(1.0, 2.0, 0.5)):
    """A .dat descriptor and its raw payload (X fastest): (path, the
    payload as (Z, Y, X))."""
    sx, sy, sz = res
    dt = FORMATS[fmt]
    if dt == np.float32:
        raw = rng.random((sz, sy, sx)).astype(dt)
    else:
        raw = rng.integers(0, np.iinfo(dt).max, (sz, sy, sx), dtype=dt)
    (tmp_path / "vol.raw").write_bytes(raw.tobytes())
    path = tmp_path / "vol.dat"
    path.write_text("ObjectFileName: vol.raw\n"
                    f"Resolution: {sx} {sy} {sz}\n"
                    "SliceThickness: " + " ".join(map(str, thickness)) + "\n"
                    f"Format: {fmt}\n")
    return str(path), raw


def write_xyz(tmp_path, rng, res=(3, 4, 5)):
    """An .xyz file (u32 x 3, f64 x 3, float32 data z fastest): (path,
    data (X, Y, Z))."""
    sx, sy, sz = res
    data = rng.random((sx, sy, sz)).astype(np.float32)
    path = tmp_path / "v.xyz"
    with open(path, "wb") as f:
        f.write(struct.pack("<3I", sx, sy, sz))
        f.write(struct.pack("<3d", 0.3, 7.0, 1.0))   # not read
        f.write(data.tobytes())
    return str(path), data


def assert_same_volume(got, want):
    assert got.world_size == want.world_size
    assert len(got.features) == len(want.features) == 1
    g, w = got.features[0], want.features[0]
    assert g.name == w.name
    assert len(g.levels) == len(w.levels)
    for lg, lw in zip(g.levels, w.levels):
        assert lg.data.dtype == lw.data.dtype
        assert lg.data.shape == lw.data.shape
        assert lg.data.tobytes() == lw.data.tobytes()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_dat_matches_jax(tmp_path, rng, fmt):
    path, raw = write_dat(tmp_path, rng, fmt)
    got, want = load_dat(path), jload_dat(path)
    assert_same_volume(got, want)
    np.testing.assert_array_equal(got.features[0].levels[0].data[..., 0],
                                  raw)
    # world size: the extent over its largest axis
    np.testing.assert_allclose(got.world_size, (0.6, 1.0, 0.2))


def test_xyz_matches_jax(tmp_path, rng):
    path, data = write_xyz(tmp_path, rng)
    got, want = load_xyz(path), jload_xyz(path)
    assert_same_volume(got, want)
    np.testing.assert_allclose(got.world_size, (0.6, 0.8, 1.0))
    lvl = got.features[0].levels[0]
    assert (lvl.size_x, lvl.size_y, lvl.size_z) == (3, 4, 5)
    # data[x, y, z] lands at lvl.data[z, y, x]
    assert lvl.data[4, 2, 1, 0] == data[1, 2, 4]


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("source", ["dat", "xyz"])
def test_main_writes_jax_bytes(tmp_path, rng, compression, source):
    """The .cvol of each package's main (two mipmap levels made, level 0
    written, as in the JAX package), byte for byte; each package loads it
    back to the same volume."""
    if source == "dat":
        path, _ = write_dat(tmp_path, rng, "USHORT", res=(12, 10, 9))
    else:
        path, _ = write_xyz(tmp_path, rng, res=(9, 12, 10))
    jout, pout = str(tmp_path / "j.cvol"), str(tmp_path / "p.cvol")
    argv = ["--compression", str(compression), "--mipmaps", "2"]
    assert jmain([path, jout] + argv) == 0
    assert main([path, pout] + argv) == 0
    with open(jout, "rb") as f, open(pout, "rb") as g:
        assert f.read() == g.read()
    back = Volume.load(pout)
    assert_same_volume(back, JVolume.load(jout))
    # a .cvol input converts to itself
    again = str(tmp_path / "again.cvol")
    assert main([pout, again, "--compression", str(compression)]) == 0
    assert_same_volume(load_any(again), back)


def test_dat_conversion_end_to_end(tmp_path, rng):
    path, raw = write_dat(tmp_path, rng, "UCHAR", thickness=(1, 1, 1))
    v = load_dat(path)
    lvl = v.features[0].levels[0]
    assert (lvl.size_x, lvl.size_y, lvl.size_z) == (6, 5, 4)
    out = str(tmp_path / "out.cvol")
    assert main([path, out]) == 0
    back = Volume.load(out).features[0].levels[0].data
    np.testing.assert_array_equal(back, lvl.data)


def test_bad_inputs_raise(tmp_path):
    (tmp_path / "bad.dat").write_text("Resolution: 2 2 2\nFormat: UCHAR\n")
    with pytest.raises(ValueError, match="ObjectFileName"):
        load_dat(str(tmp_path / "bad.dat"))
    with pytest.raises(ValueError, match="extension"):
        load_any(str(tmp_path / "v.raw"))
