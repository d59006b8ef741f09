"""Port parity, ``.volnet`` files (``fvsrn_tpu_torch/models/export.py``)
and ``LoadedModel.from_volnet`` / ``save_volnet``: a file the JAX package
writes reads back in the port as the JAX reader reads it (arrays equal),
and the port writes byte-identical files for static, time-keyframed and
time-plus-ensemble networks in all three grid encodings (float, byte
linear, byte Gaussian); a loaded model renders FUSED (the plain versions
here, on the CPU) equal to the network it was written from, up to the
format's float16 weights."""
import io

import numpy as np
import pytest
import torch

from fvsrn_tpu.models import export as jexport
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu_torch.camera import CameraOnASphere
from fvsrn_tpu_torch.inference import LoadedModel
from fvsrn_tpu_torch.models import export
from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
from tests.test_torch_segment import RAMP, port, tfs
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
ENCODINGS = [export.ENCODING_FLOAT, export.ENCODING_BYTE_LINEAR,
             export.ENCODING_BYTE_GAUSSIAN]


def jnet_of(kind, seed=3):
    rng = np.random.default_rng(seed)

    def g(*shape):
        return (rng.standard_normal(shape) * 0.2).astype(np.float32)

    lat = {"none": JLatent(),
           "static": JLatent(static_grid=g(8, 6, 6, 6)),
           "time": JLatent(time_grid=g(3, 4, 6, 6, 6), time_dependent=True),
           "time_ensemble": JLatent(time_grid=g(2, 4, 6, 6, 6),
                                    ensemble_grid=g(3, 4, 6, 6, 6),
                                    time_dependent=True)}[kind]
    return JSRN.make(layers="32:32", activation="SnakeAlt:2", num_fourier=6,
                     output_mode="density:direct", latent=lat, seed=seed)


def written(save, net, encoding, box=((-1, -2, -3), (2, 4, 6))):
    buf = io.BytesIO()
    save(net, buf, box_min=box[0], box_size=box[1], grid_encoding=encoding)
    return buf.getvalue()


@pytest.mark.parametrize("encoding", ENCODINGS)
@pytest.mark.parametrize("kind", ["none", "static", "time",
                                  "time_ensemble"])
def test_volnet_matches_jax(kind, encoding):
    jnet = jnet_of(kind)
    want = written(jexport.save_volnet, jnet, encoding)
    assert written(export.save_volnet, port(jnet), encoding) == want
    jread, jbmin, jbsize = jexport.load_volnet(io.BytesIO(want))
    net, bmin, bsize = export.load_volnet(io.BytesIO(want))
    np.testing.assert_array_equal(bmin, jbmin)
    np.testing.assert_array_equal(bsize, jbsize)
    want_arrays, want_meta = network_arrays(jread)
    got = {n: p.detach().numpy() for n, p in net.named_parameters()}
    assert set(got) == set(want_arrays)
    for k, v in want_arrays.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert net.latent.time_dependent == jread.latent.time_dependent
    assert [(l.activation, l.activation_param) for l in net.layers] == [
        (l.activation, l.activation_param) for l in jread.layers]
    # the port's file of the network it read is the same file again
    assert written(export.save_volnet, net, encoding,
                   (tuple(bmin), tuple(bsize))) == written(
        jexport.save_volnet, jread, encoding, (tuple(jbmin), tuple(jbsize)))


def test_static_grid_reads_back_static():
    """A static grid is written as one time keyframe and reads back as a
    static grid; latent vectors are not stored."""
    rng = np.random.default_rng(0)
    jnet = JSRN.make(layers="16:16", num_fourier=4, latent=JLatent(
        static_grid=rng.random((4, 4, 4, 4)).astype(np.float32),
        time_vector=rng.random((1, 2, 3)).astype(np.float32)))
    net, _, _ = export.load_volnet(io.BytesIO(written(
        export.save_volnet, port(jnet), export.ENCODING_FLOAT)))
    assert net.latent.static_grid is not None
    assert not net.latent.time_dependent
    assert net.latent.time_vector is None and net.latent.time_grid is None


def test_loaded_model_volnet_renders_fused(tmp_path):
    jnet = jnet_of("time_ensemble")
    _, tf = tfs(RAMP)
    cfg = RayEvaluationSteppingDvr.make(stepsize=1 / 32)
    model = LoadedModel(port(jnet), tf, config=cfg, box_min=(-0.5,) * 3,
                        box_size=(1.0,) * 3)
    path = str(tmp_path / "net.volnet")
    model.save_volnet(path)
    loaded = LoadedModel.from_volnet(path, tf=tf, config=cfg)
    assert loaded.box_min == model.box_min
    cam = CameraOnASphere.make(pitch=0.3, yaw=0.8, distance=1.6)
    render = loaded.prepare_network_render(cam, 16, 16, "FUSED",
                                           device="cpu")
    assert render.route == "mega"
    got = render()
    want = model.prepare_network_render(cam, 16, 16, "FUSED",
                                        device="cpu")()
    assert float(want[..., 3].max()) > 0.05
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-2)
