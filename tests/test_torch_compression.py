"""Port parity, the compression tower (``fvsrn_tpu_torch/compression.py``,
``arith.py`` and its ``native/arith.cpp``, and
``eval/eval_compression_teaser.py``): the port against the JAX package
on numpy-seeded volumes. Every codec's payload is byte for byte JAX's,
and each package decodes the other's payload to the same array bit for
bit; the arithmetic coder's 1D and 3D payloads equal JAX's and round-trip
exactly; payloads of another coder version, and the JAX package's
fallback payloads, are refused. The teaser's
table on one grid equals JAX's; end to end (the grid voxelized and the
SRN fitted by each package) its codec rows' bytes and ratios are exact
and their PSNRs within 1e-5 relative (the port's implicit grid is within
1.8e-7 of JAX's, whose XLA fuses the field's multiply-adds), and the
network row within the world trainer's 1e-4 relative
(``test_torch_world.py``). CPU only, 32^3 volumes at most."""
import contextlib
import io
import json
import os
import pickle
import struct

import numpy as np
import pytest

from fvsrn_tpu import arith as jarith
from fvsrn_tpu import compression as jcomp
from fvsrn_tpu.eval import eval_compression_teaser as jteaser
from fvsrn_tpu.volume.implicit import create_implicit_grid as jcreate_grid
from fvsrn_tpu_torch import arith, compression
from fvsrn_tpu_torch.eval import eval_compression_teaser as teaser
from fvsrn_tpu_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODECS = {
    "tthresh": dict(eps=1e-2),
    "tucker": dict(energy=1e-3),
    "quantize": dict(bits=6),
    "dwt": dict(step=5e-3),
    "dwt_chunked": dict(step=5e-3, brick=16),
}


def volumes():
    """A seeded smooth-plus-noise 32^3 volume and the all-zero one."""
    rng = np.random.default_rng(11)
    x = np.linspace(-1, 1, 32, dtype=np.float32)
    gx, gy, gz = np.meshgrid(x, x, x, indexing="ij")
    smooth = np.sin(3 * gx) * np.cos(2 * gy) + gz ** 2
    noisy = (smooth + 0.05 * rng.standard_normal(smooth.shape))
    return {"seeded": noisy.astype(np.float32),
            "zero": np.zeros((32, 32, 32), np.float32)}


@pytest.fixture(scope="module")
def payloads():
    out = {}
    for vname, v in volumes().items():
        for codec, kw in CODECS.items():
            out[vname, codec] = (
                getattr(jcomp, f"compress_{codec}")(v, **kw),
                getattr(compression, f"compress_{codec}")(v, **kw), v)
    return out


@pytest.mark.parametrize("vname", ["seeded", "zero"])
@pytest.mark.parametrize("codec", list(CODECS))
def test_codec_payload_bytes(payloads, vname, codec):
    """The payload, its size, ratio and PSNR equal JAX's; each package
    decodes the other's payload to the same array bit for bit."""
    jr, r, v = payloads[vname, codec]
    assert r.payload == jr.payload
    assert (r.compressed_bytes, r.raw_bytes, r.ratio) == \
        (jr.compressed_bytes, jr.raw_bytes, jr.ratio)
    assert r.psnr == jr.psnr or (np.isinf(r.psnr) and np.isinf(jr.psnr))
    jdec = getattr(jcomp, f"decompress_{codec}")
    dec = getattr(compression, f"decompress_{codec}")
    rec = dec(jr.payload)
    np.testing.assert_array_equal(rec, jdec(r.payload))
    assert rec.dtype == np.float32 and rec.shape == v.shape
    if vname == "zero":
        assert not rec.any()


def test_dwt_brick_and_tracker(payloads):
    """One brick of the chunked payload decodes alone to JAX's brick, and
    the memory tracker records each codec's peak and frees it."""
    jr, r, v = payloads["seeded", "dwt_chunked"]
    np.testing.assert_array_equal(
        compression.decompress_dwt_brick(r.payload, 1, 0, 1),
        jcomp.decompress_dwt_brick(jr.payload, 1, 0, 1))
    tracker = compression.MemoryTracker()
    compression.compress_quantize(v, 8, tracker=tracker)
    assert (tracker.current, tracker.peak) == (0, v.nbytes)


@pytest.mark.parametrize("nbits", [1, 7, 20])
def test_arith_round_trips(nbits):
    """1D and 3D bitplane payloads equal JAX's for the same magnitudes
    and signs, and decode to them exactly (each package's decoder on the
    other's payload too)."""
    rng = np.random.default_rng(nbits)
    shape = (6, 10, 14)
    mag = rng.integers(0, 1 << nbits, shape).astype(np.uint64)
    mag[rng.random(shape) < 0.6] = 0            # sparse, as coefficients are
    sign = (rng.random(shape) < 0.5).astype(np.uint8)
    p1 = arith.encode_planes(mag.ravel(), sign.ravel(), nbits)
    assert p1 == jarith.encode_planes(mag.ravel(), sign.ravel(), nbits)
    m1, s1 = arith.decode_planes(p1, mag.size, nbits)
    np.testing.assert_array_equal(m1, mag.ravel())
    np.testing.assert_array_equal(s1[m1 != 0], sign.ravel()[m1 != 0])
    p3 = arith.encode_planes3d(mag, sign, nbits)
    assert p3 == jarith.encode_planes3d(mag, sign, nbits)
    m3, s3 = arith.decode_planes3d(p3, shape, nbits)
    jm3, js3 = jarith.decode_planes3d(p3, shape, nbits)
    np.testing.assert_array_equal(m3, mag)
    np.testing.assert_array_equal(m3, jm3)
    np.testing.assert_array_equal(s3, js3)
    assert arith.available() and arith.available3d()
    with pytest.raises(ValueError, match="3D"):
        arith.encode_planes3d(mag.ravel(), sign.ravel(), nbits)


def reblob(data, head, edit):
    """``data`` (a tthresh/tucker-style '<ii' or dwt-style '<i' payload)
    with its pickled blob edited by ``edit``."""
    from fvsrn_tpu_torch.volume import lz4io
    if head == "<ii":
        raw_len, compressed = struct.unpack("<ii", data[:8])
        raw = lz4io.decompress(data[8:], raw_len) if compressed else data[8:]
        blob = pickle.loads(raw)
        edit(blob)
        raw = pickle.dumps(blob)
        return struct.pack("<ii", len(raw), 0) + raw
    (raw_len,) = struct.unpack("<i", data[:4])
    blob = pickle.loads(data[4:4 + raw_len])
    edit(blob)
    raw = pickle.dumps(blob)
    return struct.pack("<i", len(raw)) + raw


def test_legacy_payloads_refused(payloads):
    """A tthresh or dwt payload of another arithmetic coder version, or a
    dwt payload of an older entropy stage, raises instead of decoding to
    garbage (the DWT's ``acver`` check is the port's own: JAX's DWT
    decoder does not look)."""
    jr = payloads["seeded", "tthresh"][0]
    old = reblob(jr.payload, "<ii", lambda b: b.pop("acver"))
    for dec in (compression.decompress_tthresh, jcomp.decompress_tthresh):
        with pytest.raises(ValueError, match="legacy"):
            dec(old)
    jr = payloads["seeded", "dwt"][0]
    for edit in (lambda b: b.update(acver=1), lambda b: b.pop("acver")):
        with pytest.raises(ValueError, match="coder version"):
            compression.decompress_dwt(reblob(jr.payload, "<i", edit))
    old = reblob(jr.payload, "<i", lambda b: b.update(entropy="ac"))
    for dec in (compression.decompress_dwt, jcomp.decompress_dwt):
        with pytest.raises(ValueError, match="legacy/unknown"):
            dec(old)


def test_jax_fallback_payloads_refused(monkeypatch):
    """The port has no fallback entropy stage: the payloads the JAX
    package writes when its native coder is missing (tthresh's LZ4-packed
    planes, the DWT's LZ4 deadzone stage) are refused, not misread."""
    v = volumes()["seeded"]
    monkeypatch.setattr(jarith, "available", lambda: False)
    monkeypatch.setattr(jarith, "available3d", lambda: False)
    t = jcomp.compress_tthresh(v, 1e-2)
    d = jcomp.compress_dwt(v, 5e-3)
    seen = []
    reblob(t.payload, "<ii", lambda b: seen.append(b["entropy"]))
    reblob(d.payload, "<i", lambda b: seen.append(b["entropy"]))
    assert seen == ["lz4planes", "lz4"]
    with pytest.raises(ValueError, match="unknown tthresh payload"):
        compression.decompress_tthresh(t.payload)
    with pytest.raises(ValueError, match="legacy/unknown"):
        compression.decompress_dwt(d.payload)


def test_native_library_location():
    """The coder is the port's own source, built under
    ``build/fvsrn_tpu_torch/``, never the JAX package's library."""
    path = native.build("arith")
    assert path == arith.library_path() and os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(ROOT, "build",
                                                 "fvsrn_tpu_torch")
    assert os.path.basename(path).startswith("arith-")
    assert arith.SOURCE == os.path.join(ROOT, "fvsrn_tpu_torch", "native",
                                        "arith.cpp")


def test_teaser_table_on_one_grid():
    """``compression_teaser`` on JAX's own 16^3 grid gives JAX's table,
    every row exactly."""
    grid = np.asarray(jcreate_grid(16, "MARSCHNER_LOBB"))
    assert compression.compression_teaser(grid, 12345) == \
        jcomp.compression_teaser(grid, 12345)


def test_teaser_end_to_end():
    """The teaser at ``--resolution 16 --train-epochs 2``: the codec rows'
    bytes and ratios exact, PSNRs within 1e-5 relative; the network row's
    bytes (every parameter once, as JAX's pytree leaves) exact, its PSNR
    and final L1 within 1e-4 relative."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jteaser.main(["--resolution", "16", "--train-epochs", "2"])
    want = json.loads(buf.getvalue())
    got = teaser.teaser(16, "MARSCHNER_LOBB", 2, device="cpu")
    assert list(got) == list(want)
    for key, row in want.items():
        assert list(got[key]) == list(row), key
        if key == "network":
            assert (got[key]["bytes"], got[key]["ratio"]) == \
                (row["bytes"], row["ratio"])
            for k in ("psnr", "final_l1"):
                np.testing.assert_allclose(got[key][k], row[k], rtol=1e-4,
                                           err_msg=k)
            continue
        assert (got[key]["bytes"], got[key]["ratio"]) == \
            (row["bytes"], row["ratio"]), key
        np.testing.assert_allclose(got[key]["psnr"], row["psnr"], rtol=1e-5,
                                   err_msg=key)
