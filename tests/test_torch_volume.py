"""Port parity, voxel volumes (``fvsrn_tpu_torch/volume/{lz4io,volume,
implicit,grid}.py``, ``raytracer/iso.py``'s surface features and
``LoadedModel.render_reference``): the port against the JAX package on
the same seeded NumPy inputs.

- Files: the port's LZ4 blocks and ``.cvol`` files are byte-identical to
  the JAX package's, compressed or not, and each package loads the
  other's: v1, legacy, the lz4cpp framing with dictionary continuation
  and the round-1 framing.
- Mipmaps: "average" within 1e-6, "halton" equal.
- ``create_implicit_grid`` within 1e-6 (XLA fuses the fields'
  multiply-adds).
- Grid samplers: nearest equal, trilinear and tricubic within 1e-6;
  ``eval_normal`` within 1e-5 relative to the largest gradient;
  ``eval_curvature`` within 1e-4 where |gradient| >= 1e-3 (JAX clamps
  |g| at 1e-7, so where it vanishes the curvature is rounding noise).
- Renders: the iso render with curvature features on a grid, >= 99% of
  the pixels within 1e-4; ``render_reference`` at 32x32 within 1e-5.

Volumes have a different size on each axis and no symmetry, so a
transposed axis shows. CPU only, small sizes."""
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.inference import LoadedModel as JLoadedModel
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.raytracer.iso import RayEvaluationSteppingIso as JIso
from fvsrn_tpu.raytracer.iso import trace_iso as jtrace_iso
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu.volume import lz4io as jlz4io
from fvsrn_tpu.volume.grid import VolumeInterpolationGrid as JGrid
from fvsrn_tpu.volume.implicit import VolumeInterpolationImplicit as JImplicit
from fvsrn_tpu.volume.implicit import create_implicit_grid as jcreate_grid
from fvsrn_tpu.volume.volume import MipmapLevel as JMipmapLevel
from fvsrn_tpu.volume.volume import Volume as JVolume
from fvsrn_tpu_torch.camera import CameraOnASphere, generate_rays
from fvsrn_tpu_torch.inference import LoadedModel
from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
from fvsrn_tpu_torch.raytracer.dvr import max_steps_bound
from fvsrn_tpu_torch.raytracer.iso import RayEvaluationSteppingIso, trace_iso
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from fvsrn_tpu_torch.volume import lz4io
from fvsrn_tpu_torch.volume.grid import VolumeInterpolationGrid
from fvsrn_tpu_torch.volume.implicit import (VolumeInterpolationImplicit,
                                             create_implicit_grid)
from fvsrn_tpu_torch.volume.volume import MipmapLevel, Volume

torch.set_num_threads(1)
CPU = "cpu"
CAM = dict(pitch=0.4, yaw=0.7, distance=1.7)
TF = dict(rgb=[[0.9, 0.4, 0.1], [0.2, 0.5, 1.0], [1.0, 1.0, 0.6]],
          opacity=[0.0, 7.0, 20.0], positions=[0.0, 0.4, 1.0])


def smooth_field(shape, seed=0):
    """(X, Y, Z) float32 in [0, 1]: a seeded sum of sinusoids on a grid
    with a different size on each axis (no symmetry)."""
    rng = np.random.default_rng(seed)
    axes = [np.linspace(-1, 1, n) for n in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    f = np.zeros(shape)
    for _ in range(4):
        k = rng.uniform(0.5, 2.5, 3)
        f += rng.uniform(0.2, 1.0) * np.sin(k[0] * x + k[1] * y ** 2
                                            + k[2] * z + rng.uniform(0, 6))
    f = (f - f.min()) / (f.max() - f.min())
    return f.astype(np.float32)


def write_both(tmp_path, features, world_size=(1.0, 2.0, 3.0),
               compression=0):
    """The same features saved by both packages; returns the two
    paths."""
    paths = []
    for pkg, cls in (("jax", JVolume), ("port", Volume)):
        v = cls(world_size=world_size)
        for name, data in features:
            v.add_feature(name, data)
        p = str(tmp_path / f"{pkg}-{compression}.cvol")
        v.save(p, compression=compression)
        paths.append(p)
    return paths


def features(rng):
    """Three features: float (Z, Y, X, 1) noise over 64 KB (two LZ4
    chunks), a uchar 3-channel feature and a ushort one."""
    return [
        ("density", (np.round(rng.random((20, 33, 41, 1)) * 8) / 8).astype(
            np.float32)),
        ("color", rng.integers(0, 255, (7, 8, 9, 3)).astype(np.uint8)),
        ("count", rng.integers(0, 4000, (5, 6, 7, 1)).astype(np.uint16)),
    ]


def test_lz4_blocks_equal_jax(rng):
    """The port's codec gives JAX's blocks byte for byte, and each
    decodes the other's."""
    for raw in (b"", b"abc", bytes(rng.integers(0, 4, 70000, np.uint8)),
                np.linspace(0, 1, 30000, dtype=np.float32).tobytes()):
        comp = lz4io.compress(raw)
        assert comp == jlz4io.compress(raw)
        assert lz4io.decompress(comp, len(raw)) == raw
        assert jlz4io.decompress(comp, len(raw)) == raw
    with pytest.raises(RuntimeError):
        lz4io.decompress(b"\xff\xff\xff", 10)


def test_lz4_builds_into_build_dir():
    """The codec is built from the port's own source into the repo's
    build directory, not into the JAX package."""
    path = lz4io.library_path()
    assert lz4io.build() == path and os.path.exists(path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path.startswith(os.path.join(root, "build", "fvsrn_tpu_torch"))
    assert lz4io.SOURCE == os.path.join(root, "fvsrn_tpu_torch", "native",
                                        "lz4.cpp")


@pytest.mark.parametrize("compression", [0, 1])
def test_cvol_files_byte_identical(tmp_path, rng, compression):
    jp, pp = write_both(tmp_path, features(rng), compression=compression)
    with open(jp, "rb") as f, open(pp, "rb") as g:
        jbytes, pbytes = f.read(), g.read()
    assert jbytes == pbytes
    # each package loads the other's file
    for path in (jp, pp):
        got, want = Volume.load(path), JVolume.load(path)
        assert got.world_size == want.world_size == (1.0, 2.0, 3.0)
        assert [f.name for f in got.features] == ["density", "color",
                                                  "count"]
        for fg, fw in zip(got.features, want.features):
            assert fg.dtype_code == fw.dtype_code
            np.testing.assert_array_equal(fg.levels[0].data,
                                          fw.levels[0].data)
        np.testing.assert_array_equal(got.density, want.density)
        assert got.estimate_memory() == want.estimate_memory()


def test_compressed_file_smaller(tmp_path, rng):
    _, pp0 = write_both(tmp_path, features(rng), compression=0)
    _, pp1 = write_both(tmp_path, features(rng), compression=1)
    assert os.path.getsize(pp1) < os.path.getsize(pp0)


def _legacy_header(sx, sy, sz, voxel, dtype_code, compressed):
    return (b"cvol" + struct.pack("<3Q", sx, sy, sz)
            + struct.pack("<3d", *voxel) + struct.pack("<I", dtype_code)
            + (b"\x01" if compressed else b"\x00") + b"\x00" * 7)


@pytest.mark.parametrize("compressed", [False, True])
def test_legacy_format_loads_as_jax(tmp_path, rng, compressed):
    """A legacy 'cvol' file (X fastest, voxel size in the header): same
    data and world size (size x voxel size) in both packages."""
    sx, sy, sz = 9, 8, 7
    data = rng.random((sz, sy, sx)).astype(np.float32)
    payload = data.tobytes()
    body = payload
    if compressed:
        comp = jlz4io.compress(payload)
        body = struct.pack("<i", len(comp)) + comp
    p = str(tmp_path / "legacy.cvol")
    with open(p, "wb") as f:
        f.write(_legacy_header(sx, sy, sz, (0.5, 0.25, 0.125), 2,
                               compressed) + body)
    got, want = Volume.load(p), JVolume.load(p)
    assert got.world_size == want.world_size == (4.5, 2.0, 0.875)
    np.testing.assert_array_equal(got.features[0].levels[0].data[..., 0],
                                  data)
    np.testing.assert_array_equal(got.density, want.density)


def test_lz4cpp_dictionary_continuation(tmp_path, rng):
    """A compressed v1 payload whose second chunk back-references the
    first chunk's output (streamed compression with dictionary
    continuation) decodes to the same bytes in both packages."""
    chunk1 = bytes(rng.integers(0, 16, 65536, np.uint8))
    off = 1000
    tail = bytes(rng.integers(0, 255, 5, np.uint8))
    # [token: 0 literals, match 15 + 40 + 4 = 59][offset][40] then the
    # last sequence of 5 literals
    block2 = bytes([0x0F, off & 0xFF, off >> 8, 40, 0x50]) + tail
    payload = chunk1 + chunk1[65536 - off:65536 - off + 59] + tail
    assert len(payload) == 41 * 40 * 40
    c1 = lz4io.compress(chunk1)
    p = str(tmp_path / "stream.cvol")
    with open(p, "wb") as f:
        f.write(b"CVOL" + struct.pack("<i", 1) + struct.pack("<3f", 1, 1, 1)
                + struct.pack("<i", 1) + struct.pack("<i", 1) + b"\x00" * 4)
        f.write(struct.pack("<i", 7) + b"density"
                + struct.pack("<3Q", 40, 40, 41) + struct.pack("<i", 1)
                + struct.pack("<i", 0))
        for block in (c1, block2):
            f.write(struct.pack("<i", len(block)) + block)
    got, want = Volume.load(p), JVolume.load(p)
    np.testing.assert_array_equal(got.features[0].levels[0].data,
                                  want.features[0].levels[0].data)
    assert got.features[0].levels[0].data.tobytes() == payload
    # the decoder alone, as the JAX package's own test drives it
    prefix = b"ABCDEFGH" * 4
    block = bytes([0x04, 32, 0]) + bytes([0x50]) + b"WXYZV"
    out = np.empty(len(prefix) + 13, np.uint8)
    out[:len(prefix)] = np.frombuffer(prefix, np.uint8)
    assert lz4io.decompress_into(block, out, len(prefix)) == 13
    assert out[len(prefix):].tobytes() == prefix[:8] + b"WXYZV"


def test_round1_framing_fallback(tmp_path, rng):
    """Files in the round-1 framing ([rawLen | compLen | block]*) load in
    both packages."""
    data = (rng.random((7, 8, 9)) < 0.2).astype(np.float32)
    v = Volume()
    v.add_feature("density", data)
    lvl = v.features[0].levels[0]
    payload = lvl.data.tobytes()
    p = str(tmp_path / "old.cvol")
    with open(p, "wb") as s:
        s.write(b"CVOL" + struct.pack("<i", 1) + struct.pack("<3f", 1, 1, 1)
                + struct.pack("<i", 1) + struct.pack("<i", 1) + b"\x00" * 4)
        s.write(struct.pack("<i", 7) + b"density")
        s.write(struct.pack("<3Q", lvl.size_x, lvl.size_y, lvl.size_z))
        s.write(struct.pack("<i", 1) + struct.pack("<i", 2))
        comp = lz4io.compress(payload)
        s.write(struct.pack("<ii", len(payload), len(comp)) + comp)
    got, want = Volume.load(p), JVolume.load(p)
    np.testing.assert_array_equal(got.features[0].levels[0].data,
                                  lvl.data)
    np.testing.assert_array_equal(got.density, want.density)
    np.testing.assert_array_equal(got.density, data)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.uint16])
def test_mipmap_level_tensor_matches_jax(rng, dtype):
    hi = 1 if dtype == np.float32 else np.iinfo(dtype).max
    data = (rng.random((3, 4, 5, 2)) * hi).astype(dtype)
    got, want = MipmapLevel(data.copy()), JMipmapLevel(data.copy())
    t = got.to_tensor()
    assert t.shape == (2, 5, 4, 3)
    np.testing.assert_array_equal(t, want.to_tensor())
    got.from_tensor(t * 0.5)
    want.from_tensor(t * 0.5)
    np.testing.assert_array_equal(got.data, want.data)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_mipmaps_match_jax(rng, dtype):
    data = (rng.random((9, 10, 11, 2)) * (1 if dtype == np.float32 else 255)
            ).astype(dtype)
    got, want = Volume(), JVolume()
    got.add_feature("d", data)
    want.add_feature("d", data)
    for level in (1, 2, 3):
        got.features[0].create_mipmap_level(level, "average")
        want.features[0].create_mipmap_level(level, "average")
        g = got.features[0].levels[level].data
        w = want.features[0].levels[level].data
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), atol=1e-6, rtol=0)
    got.features[0].delete_all_mipmap_levels()
    want.features[0].delete_all_mipmap_levels()
    for level in (1, 3):
        got.features[0].create_mipmap_level(level, "halton")
        want.features[0].create_mipmap_level(level, "halton")
        np.testing.assert_array_equal(got.features[0].levels[level].data,
                                      want.features[0].levels[level].data)
    with pytest.raises(ValueError):
        got.features[0].create_mipmap_level(2, "bogus")


def test_histogram_and_synthetic_dataset():
    def fn(x, y, z):
        return np.sin(3 * x) * np.cos(2 * y) + z * z

    got = Volume.create_synthetic_dataset(13, -1.0, 1.0, fn)
    want = JVolume.create_synthetic_dataset(13, -1.0, 1.0, fn)
    np.testing.assert_array_equal(got.density, want.density)
    for a, b in zip(got.histogram(bins=32), want.histogram(bins=32)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("equation", ["MARSCHNER_LOBB", "SPHERE", "BLOBBY",
                                      "CUBE"])
def test_create_implicit_grid_matches_jax(equation):
    """The voxel coordinates and layout; every field's formula is held to
    JAX's by tests/test_torch_train.py::test_implicit_equation (1e-5:
    MULTI_SHELL's exp and atan2 read ~1e-6 off on this grid)."""
    got = create_implicit_grid(17, equation, device=CPU)
    want = np.asarray(jcreate_grid(17, equation))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    vol = Volume.create_implicit_dataset(17, equation, device=CPU)
    jvol = JVolume.create_implicit_dataset(17, equation)
    np.testing.assert_allclose(vol.density, jvol.density, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(vol.density, got.numpy())


def test_implicit_eval_normal_matches_jax(rng):
    """Central differences at step 1e-3: JAX's densities within 1e-6
    (fused multiply-adds), so the normals within 1e-6 / 1e-3."""
    pos = rng.uniform(-0.5, 0.5, (2000, 3)).astype(np.float32)
    got = VolumeInterpolationImplicit.make("MARSCHNER_LOBB").eval_normal(
        torch.from_numpy(pos))
    want = np.asarray(JImplicit.make("MARSCHNER_LOBB").eval_normal(
        jnp.asarray(pos)))
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def grids(shape=(12, 14, 16), interpolation="trilinear", batch=False,
          **kw):
    data = smooth_field(shape)
    if batch:
        data = np.stack([smooth_field(shape, seed=5), data])
    return (JGrid.from_grid(jnp.asarray(data), interpolation=interpolation,
                            **kw),
            VolumeInterpolationGrid.from_grid(data,
                                              interpolation=interpolation,
                                              **kw))


def positions(n=4096, seed=3, margin=0.05):
    """Seeded world positions over the default box of a (12, 14, 16)
    grid, a little past its faces (clamped corners)."""
    half = np.array([12, 14, 16]) / 16 / 2 + margin
    return np.random.default_rng(seed).uniform(-half, half, (n, 3)).astype(
        np.float32)


@pytest.mark.parametrize("interpolation", ["nearest", "trilinear",
                                           "tricubic"])
@pytest.mark.parametrize("variant", ["default", "old_resolution", "batched"])
def test_grid_samplers_match_jax(interpolation, variant):
    kw = dict(old_resolution_behavior=variant == "old_resolution",
              batch=variant == "batched")
    jg, g = grids(interpolation=interpolation, **kw)
    b = 1 if variant == "batched" else 0
    assert g.batch == jg.batch and g.resolution == jg.resolution
    np.testing.assert_array_equal(g.box_min.numpy(), np.asarray(jg.box_min))
    np.testing.assert_array_equal(g.box_size.numpy(),
                                  np.asarray(jg.box_size))
    pos = positions()
    value, inside = g.eval_density(torch.from_numpy(pos), b=b)
    jvalue, jinside = jg.eval_density(jnp.asarray(pos), b=b)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(jinside))
    assert 0 < inside.float().mean() < 1
    if interpolation == "nearest":
        np.testing.assert_array_equal(value.numpy(), np.asarray(jvalue))
    else:
        np.testing.assert_allclose(value.numpy(), np.asarray(jvalue),
                                   atol=1e-6, rtol=0)
    normal = g.eval_normal(torch.from_numpy(pos), b=b).numpy()
    jnormal = np.asarray(jg.eval_normal(jnp.asarray(pos), b=b))
    scale = np.abs(jnormal).max()
    assert scale > 0.1
    np.testing.assert_allclose(normal, jnormal, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("interpolation", ["trilinear", "tricubic"])
def test_grid_curvature_matches_jax(interpolation):
    """Principal curvatures within 1e-4 where |gradient| >= 1e-3 (below,
    the projected Hessian is divided by a vanishing |g| and JAX's own
    value is rounding noise)."""
    jg, g = grids(interpolation=interpolation)
    pos = positions(2048, margin=-0.1)
    curv = g.eval_curvature(torch.from_numpy(pos)).numpy()
    jcurv = np.asarray(jg.eval_curvature(jnp.asarray(pos)))
    gnorm = np.linalg.norm(np.asarray(jg.eval_normal(jnp.asarray(pos))),
                           axis=-1)
    keep = gnorm >= 1e-3
    assert keep.mean() > 0.9 and np.abs(jcurv[keep]).max() > 0.5
    np.testing.assert_allclose(curv[keep], jcurv[keep], atol=1e-4, rtol=0)


def test_grid_to_device_and_from_tensor():
    data = smooth_field((5, 6, 7))
    g = VolumeInterpolationGrid.from_grid(torch.from_numpy(data),
                                          interpolation="tricubic",
                                          box_min=(0, 0, 0),
                                          box_size=(1, 2, 3))
    g2 = g.to(CPU)
    assert g2.interpolation == "tricubic" and g2.resolution == (5, 6, 7)
    np.testing.assert_array_equal(g2.box_size.numpy(), [1, 2, 3])
    with pytest.raises(ValueError):
        VolumeInterpolationGrid.from_grid(data, interpolation="cubic")


def iso_texture(shape, seed=11):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


ISO = dict(stepsize=1 / 64, isovalue=0.5, binary_search_steps=6,
           isocontour_range=8.0)


class _AtHits:
    """JAX's normal and curvature at the hits, evaluated once and handed
    to JAX's shading of each feature."""

    def __init__(self, normal, curvature):
        self.normal, self.curvature = normal, curvature

    def eval_normal(self, position, direction=None, b=0):
        return self.normal

    def eval_curvature(self, position, direction=None, b=0):
        return self.curvature


@pytest.fixture(scope="module")
def iso_case():
    """A trilinear grid, 32x32 rays and JAX's march and bisection of them
    (``trace_iso``, no feature), with JAX's normal and curvature at the
    hits that every feature shades."""
    jg, g = grids()
    rs, rd = generate_rays(CameraOnASphere.make(**CAM), 32, 32, device=CPU)
    rs, rd = rs[0], rd[0]
    steps = max_steps_bound(g.box_size.tolist(), ISO["stepsize"])
    jrs, jrd = jnp.asarray(rs.numpy()), jnp.asarray(rd.numpy())
    hit = jtrace_iso(jrs, jrd, jg, JIso.make(**ISO), steps)
    pos = jrs + jrd * hit.depth
    at_hits = _AtHits(jg.eval_normal(pos), jg.eval_curvature(pos))
    return g, rs, rd, steps, hit, pos, at_hits


@pytest.mark.parametrize("feature,tex_shape", [
    ("curvature_texture", (16, 16, 4)), ("mean", (32, 4)),
    ("gaussian", (32, 4)), ("first_principal", (32, 4)),
    ("second_principal", (32, 4))])
def test_iso_surface_features_on_grid_match_jax(iso_case, feature,
                                                tex_shape):
    """The port's ``trace_iso`` on a trilinear grid with a curvature
    feature against JAX's: the same march and bisection (``trace_iso``)
    and JAX's shading of the feature at its hits (``iso._shade``, the
    last step of its ``trace_iso``, on JAX's normal and curvature there). >= 99% of the 32x32 pixels within
    1e-4 (a hit whose curvature sits on a texel edge may take the
    neighbouring texel)."""
    from fvsrn_tpu.raytracer.iso import _shade as jshade
    g, rs, rd, steps, hit, pos, at_hits = iso_case
    tex = iso_texture(tex_shape)
    got = trace_iso(rs, rd, g, RayEvaluationSteppingIso.make(
        **ISO, surface_feature=feature, isocontour_texture=tex), steps)
    found = np.asarray(hit.color)[..., 3:4] > 0.5
    jcolor, jnormal = jshade(
        JIso.make(**ISO, surface_feature=feature,
                  isocontour_texture=jnp.asarray(tex)), at_hits, pos,
        jnp.asarray(rd.numpy()), jnp.asarray(found), 0)
    color, jcolor = got.color.numpy(), np.asarray(jcolor)
    assert found.mean() > 0.2
    close = np.all(np.abs(color - jcolor) <= 1e-4, axis=-1)
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(hit.depth),
                               atol=1e-5)
    np.testing.assert_allclose(got.normal.numpy(), np.asarray(jnormal),
                               atol=1e-4)


def test_render_reference_matches_jax():
    """``LoadedModel.render_reference`` of a grid at 32x32, the model's
    default stepsize 1/256, within 1e-5."""
    jg, g = grids()
    jtf, tf = JTF.make(**TF), TransferFunctionPiecewiseLinear.make(**TF)
    jm = JLoadedModel(JSRN.make(layers="16", num_fourier=0, seed=1), jtf,
                      reference_volume=jg)
    m = LoadedModel(SceneRepresentationNetwork.make(layers="16",
                                                    num_fourier=0, seed=1),
                    tf, reference_volume=g)
    want = np.asarray(jm.render_reference(JCam.make(**CAM), 32, 32))
    got = m.render_reference(CameraOnASphere.make(**CAM), 32, 32,
                             device=CPU)
    assert got.shape == (32, 32, 4) and want[..., 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        LoadedModel(m.network, tf).render_reference(
            CameraOnASphere.make(**CAM), 8, 8, device=CPU)
