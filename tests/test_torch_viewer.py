"""Port parity, the browser viewer (``fvsrn_tpu_torch/viewer.py`` against
``fvsrn_tpu/viewer.py``): the JAX package's three tests
(tests/test_viewer.py: page and render, the PNG writer, progressive
Monte-Carlo refinement) on the port with ``device="cpu"``; the same
``/render`` requests to both packages' servers decode to images within 1
LSB on at least 99% of the pixels; a render error answers 500 with JSON;
and the page retries after a failed fetch (the port's repair, ROADMAP
§C)."""
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

import fvsrn_tpu as fv
from fvsrn_tpu.viewer import serve as jserve
from fvsrn_tpu_torch.camera import CameraOnASphere
from fvsrn_tpu_torch.phase import PhaseFunctionHenyeyGreenstein
from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
from fvsrn_tpu_torch.raytracer.evaluator import ImageEvaluatorSimple
from fvsrn_tpu_torch.raytracer.montecarlo import RayEvaluationMonteCarlo
from fvsrn_tpu_torch.transfer import (TransferFunctionIdentity,
                                      TransferFunctionPiecewiseLinear)
from fvsrn_tpu_torch.viewer import _PAGE, _encode_png, serve
from fvsrn_tpu_torch.volume.implicit import VolumeInterpolationImplicit

LSB_SHARE = 0.99   # pixels within 1 LSB of the JAX server's
TF = dict(rgb=[[0.9, 0.2, 0.1], [1.0, 1.0, 0.6]], opacity=[0.0, 25.0],
          positions=[0.0, 1.0])


def _evaluator():
    return ImageEvaluatorSimple(
        camera=CameraOnASphere.make(pitch=0.3, yaw=0.5, distance=1.6),
        volume=VolumeInterpolationImplicit.make("SPHERE"),
        tf=TransferFunctionPiecewiseLinear.make(**TF),
        ray_config=RayEvaluationSteppingDvr.make(stepsize=1 / 32))


def _jax_evaluator():
    return fv.ImageEvaluatorSimple(
        camera=fv.CameraOnASphere.make(pitch=0.3, yaw=0.5, distance=1.6),
        volume=fv.VolumeInterpolationImplicit.make("SPHERE"),
        tf=fv.TransferFunctionPiecewiseLinear.make(**TF),
        ray_config=fv.RayEvaluationSteppingDvr.make(stepsize=1 / 32))


def get(url, timeout=120):
    return urllib.request.urlopen(url, timeout=timeout)


def decode(png):
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def test_viewer_serves_page_and_render():
    server = serve(_evaluator(), port=0, block=False, device="cpu")
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        page = get(f"{base}/", 30).read()
        assert b"fvsrn_tpu viewer" in page
        png = get(f"{base}/render?size=64&pitch=0.3&yaw=0.5"
                  "&distance=1.6").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        # orbit + opacity edit produce a different image
        png2 = get(f"{base}/render?size=64&pitch=0.3&yaw=2.5&distance=1.6"
                   "&opacity=0.3").read()
        assert png2[:8] == b"\x89PNG\r\n\x1a\n" and png2 != png
        meta = json.loads(get(f"{base}/meta", 30).read())
        assert meta == {"progressive": False, "max_frames": 32}
        with pytest.raises(urllib.error.HTTPError) as err:
            get(f"{base}/nothing", 30)
        assert err.value.code == 404
    finally:
        server.shutdown()


def test_viewer_png_fallback_encoder():
    """The no-PIL PNG writer emits decodable files."""
    rng = np.random.default_rng(0)
    arr = (rng.random((17, 23, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(decode(_encode_png(arr)), arr)


def test_viewer_progressive_mc():
    """MC evaluators refine progressively across same-camera requests:
    /meta flags progressive mode, X-Frames counts the accumulated passes,
    and a camera change resets the accumulator."""
    ev = ImageEvaluatorSimple(
        camera=CameraOnASphere.make(pitch=0.3, yaw=0.5, distance=1.6),
        volume=VolumeInterpolationImplicit.make("SPHERE"),
        tf=TransferFunctionIdentity.make(absorption=8.0, emission=1.0),
        ray_config=RayEvaluationMonteCarlo.make(
            max_absorption=8.0, density_min=0.3, num_bounces=1,
            max_iterations=32),
        phase=PhaseFunctionHenyeyGreenstein.make(g=0.0), ray_mode="mc")
    server = serve(ev, port=0, block=False, device="cpu")
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        meta = json.loads(get(f"{base}/meta", 30).read())
        assert meta["progressive"] is True
        url = f"{base}/render?size=16&pitch=0.3&yaw=0.5&distance=1.6"
        assert get(url, 300).headers["X-Frames"] == "1"
        assert get(url, 300).headers["X-Frames"] == "2"
        r3 = get(f"{base}/render?size=16&pitch=0.3&yaw=2.0&distance=1.6",
                 300)
        assert r3.headers["X-Frames"] == "1"
    finally:
        server.shutdown()


@pytest.mark.parametrize("query", [
    "size=32&pitch=0.3&yaw=0.5&distance=1.6",
    "size=48&pitch=-0.4&yaw=2.5&distance=1.9&opacity=0.3",
    "size=32&pitch=0.9&yaw=4.0&distance=1.2&opacity=2.5"])
def test_render_matches_jax_server(query):
    """The same request to both packages' servers: decoded images within
    1 LSB on >= 99% of the pixels (the float32 marches are ~1e-6 apart,
    so a pixel on a rounding edge may land on the other LSB)."""
    ours = serve(_evaluator(), port=0, block=False, device="cpu")
    theirs = jserve(_jax_evaluator(), port=0, block=False)
    try:
        got = decode(get(f"http://127.0.0.1:{ours.server_port}/render?"
                         + query).read())
        want = decode(get(f"http://127.0.0.1:{theirs.server_port}/render?"
                          + query).read())
    finally:
        ours.shutdown()
        theirs.shutdown()
    assert got.shape == want.shape
    assert want.max() > 100
    diff = np.abs(got.astype(int) - want.astype(int)).max(axis=-1)
    assert float((diff <= 1).mean()) >= LSB_SHARE
    assert diff.max() <= 2


def test_render_error_answers_500_with_json():
    ev = _evaluator()
    server = serve(ev, port=0, block=False, device="cpu")
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            get(f"http://127.0.0.1:{server.server_port}/render?size=-4", 30)
        assert err.value.code == 500
        body = json.loads(err.value.read())
        assert set(body) == {"error"}
    finally:
        server.shutdown()


def test_page_retries_after_a_failed_fetch():
    """The refresh loop's catch re-schedules it with a backoff, keeping
    the pending change and the progressive loop (the JAX page's catch only
    clears ``busy``)."""
    catch = _PAGE[_PAGE.index("} catch (e) {"):_PAGE.index("for (const el")]
    assert "setTimeout(refresh" in catch
    assert "busy = false" in catch
    assert "dirty = false" not in catch


def test_viewer_serves_a_cvol(tmp_path):
    """``--cvol``: the volume file's first feature as a grid volume (the
    JAX viewer calls a ``VolumeInterpolationGrid.make`` its grid class
    does not have, so its ``--cvol`` raises ``AttributeError``)."""
    from fvsrn_tpu_torch.viewer import default_evaluator
    from fvsrn_tpu_torch.volume.volume import Volume
    vol = Volume.create_implicit_dataset(24, "MARSCHNER_LOBB", device="cpu")
    path = str(tmp_path / "v.cvol")
    vol.save(path, compression=1)
    ev = default_evaluator(cvol=path, stepsize=1 / 32, device="cpu")
    server = serve(ev, port=0, block=False, device="cpu")
    try:
        png = get(f"http://127.0.0.1:{server.server_port}/render?size=24"
                  "&distance=1.6").read()
    finally:
        server.shutdown()
    img = decode(png)
    assert img.shape == (24, 24, 3) and img.max() > 50


def test_main_raises_without_the_card():
    """``main``'s ``--device`` defaults to the card and raises where there
    is none, before it serves (no fallback to the CPU)."""
    import torch
    from fvsrn_tpu_torch.viewer import main
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would serve")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--port", "0"])
