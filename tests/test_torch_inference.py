"""Port parity, end to end: the port's product render of the dense
flagship (``LoadedModel.render_network`` in FUSED mode, through the
plain version of the fused march on the CPU) against the JAX package's
(Pallas interpret mode) at 32x32, stepsize 1/128, atol 1e-4; PLAIN32
against PLAIN32; and the port's device, mode and route guards."""
import numpy as np
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import camera_matrix as jcamera_matrix
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.inference import LoadedModel as JLoadedModel
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.ops.fused_dvr import block_ray_permutation as jblock_perm
from fvsrn_tpu.ops.fused_dvr import probe_saturation_tmax as jprobe
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import max_steps_bound
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.scenes import dense_scene as jdense_scene
from fvsrn_tpu_torch.camera import CameraOnASphere
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.inference import LoadedModel
from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
from fvsrn_tpu_torch.scenes import dense_scene
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
H = 1 / 128
W = 32
CAM = dict(pitch=0.3, yaw=0.5, distance=1.6)


@pytest.fixture(scope="module")
def models():
    _, jtf, ckpt = jdense_scene()
    jm = JLoadedModel.from_checkpoint(ckpt, tf=jtf)
    jm.config = JCfg.make(stepsize=H)
    _, tf, npz = dense_scene()
    m = LoadedModel.from_checkpoint(
        npz, tf=tf, config=RayEvaluationSteppingDvr.make(stepsize=H))
    return jm, m


def test_saturation_clip_matches_jax(models):
    """The probe marches the f32 grid in both packages; a ray whose
    alpha >= 0.999 crossing flipped would move its clip by 8 steps."""
    jm, m = models
    mat = np.asarray(jcamera_matrix(JCam.make(**CAM)))
    rs, rd = jgenerate_rays(mat, W, W, JCam.make(**CAM).fov_y_radians)
    perm, _ = jblock_perm(W, W, 16, 16)
    rs = np.asarray(rs).reshape(-1, 3)[perm]
    rd = np.asarray(rd).reshape(-1, 3)[perm]
    want = jprobe(rs, rd, JVolume.make(jm.network), jm.tf, stepsize=H,
                  max_steps=max_steps_bound((1.0, 1.0, 1.0), H), coarse=8,
                  margin_steps=16)
    render = m.prepare_network_render(CameraOnASphere.make(**CAM), W, W,
                                      "FUSED", device="cpu")
    np.testing.assert_allclose(render.ray_start.numpy(), rs, atol=1e-6)
    np.testing.assert_allclose(render.ray_dir.numpy(), rd, atol=1e-6)
    np.testing.assert_allclose(render.tmax_clip.numpy(), want, atol=1e-5)


def test_fused_render_matches_jax(models):
    jm, m = models
    want = np.asarray(jm.render_network(JCam.make(**CAM), W, W, "FUSED",
                                        interpret=True))
    got = m.render_network(CameraOnASphere.make(**CAM), W, W, "FUSED",
                           device="cpu").numpy()
    assert got.shape == (W, W, 4)
    assert want[..., 3].max() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_plain32_matches_jax(models):
    jm, m = models
    want = np.asarray(jm.render_network(JCam.make(**CAM), W, W, "PLAIN32"))
    got = m.render_network(CameraOnASphere.make(**CAM), W, W, "PLAIN32",
                           device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_default_device_is_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    _, m = models
    cam = CameraOnASphere.make(**CAM)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.render_network(cam, W, W)
    with pytest.raises(RuntimeError, match="CUDA"):
        m.prepare_network_render(cam, W, W, "PLAIN32")
    with pytest.raises(RuntimeError, match="CUDA"):
        m.time_rendering([cam], W, W, device="cpu")


def test_mode_and_size_guards(models):
    """Every mode of the JAX package is served: W or H not a multiple of
    16 takes the per-segment engine (route 2), FUSED_BF16 is FUSED for
    DVR and PLAIN16 a plain render; an unknown mode raises. A color
    output network takes the megakernel's route as in the JAX package
    and renders as its FUSED render does (atol 1e-4)."""
    jm, m = models
    cam = CameraOnASphere.make(**CAM)
    assert m.prepare_network_render(cam, 24, 32, "FUSED",
                                    device="cpu").route == "segment"
    assert m.prepare_network_render(cam, W, W, "FUSED_BF16",
                                    device="cpu").route == "mega"
    assert m.prepare_network_render(cam, W, W, "PLAIN16",
                                    device="cpu")().shape == (W, W, 4)
    with pytest.raises(ValueError):
        m.prepare_network_render(cam, W, W, "BOGUS", device="cpu")
    jnet = JSRN.make(output_mode="rgbo", latent=JLatent(
        static_grid=np.zeros((4, 8, 8, 8), np.float32)))
    rgbo = LoadedModel(srn_from_arrays(*network_arrays(jnet)), m.tf,
                       config=m.config)
    render = rgbo.prepare_network_render(cam, W, W, "FUSED", device="cpu")
    assert render.route == "mega"
    want = np.asarray(JLoadedModel(jnet, jm.tf, config=jm.config)
                      .render_network(JCam.make(**CAM), W, W, "FUSED",
                                      interpret=True))
    assert want[..., 3].max() > 0.5
    np.testing.assert_allclose(render().numpy(), want, atol=1e-4)


def test_rotation_cameras():
    cams = LoadedModel.rotation_cameras(4)
    jcams = JLoadedModel.rotation_cameras(4)
    for c, jc in zip(cams, jcams):
        np.testing.assert_allclose(c.pitch_yaw_distance.numpy(),
                                   jc.pitch_yaw_distance, atol=1e-7)
