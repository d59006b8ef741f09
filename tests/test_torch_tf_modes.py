"""Port parity, the TF modes of the fused marches (the texture, 1D- and
2D-preintegrated and Gaussian branches of TPU kernel rows 1-6, forward):
the port's plain per-segment march (``fused_trace_dvr_plain``, per-ray
sampling and the lattice) and plain megakernel march
(``mega_trace_dvr_plain``) against the JAX package's ``fused_trace_dvr``
and ``mega_trace_dvr`` in Pallas interpret mode, on the same numpy-seeded
network, rays and TF tables: image atol 1e-4, the contract of
tests/test_fused.py. Also the previous-density chain across segment
boundaries, the near branch of the 1D preintegration, the lattice's
first-sample sentinel, and the product render
(``LoadedModel.prepare_network_render(mode="FUSED")``) with each texture
TF against the JAX package's, and its refusal of a Gaussian TF, whose
JAX render is not the TF's image. The CUDA kernels are held against these
plain versions on the card by tests/test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.inference import LoadedModel as JLoadedModel
from fvsrn_tpu.ops.fused_dvr import fused_trace_dvr as jfused
from fvsrn_tpu.ops.fused_mega import mega_trace_dvr as jmega
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.scenes import dense_scene as jdense_scene
from fvsrn_tpu.transfer import TransferFunctionGaussian as JGauss
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu.transfer import TransferFunctionTexture as JTex
from fvsrn_tpu_torch.camera import CameraOnASphere
from fvsrn_tpu_torch.inference import LoadedModel
from fvsrn_tpu_torch.ops import fused_dvr
from fvsrn_tpu_torch.ops.fused_dvr import fused_trace_dvr_plain
from fvsrn_tpu_torch.ops.fused_mega import mega_trace_dvr_plain
from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
from fvsrn_tpu_torch.scenes import dense_scene
from fvsrn_tpu_torch.transfer import (TransferFunctionGaussian,
                                      TransferFunctionTexture)
from tests.test_torch_segment import (BMIN, BSIZE, RAMP, jnet_of, port,
                                      rays16, t)

torch.set_num_threads(1)
H = 1 / 32
SEG, TILE = 8, 64
STEPS = 56
MODES = ("texture", "preint1d", "preint2d", "gaussian")
ENGINES = ("segment", "lattice", "mega")
GAUSSIANS = [[0.9, 0.1, 0.1, 10.0, 0.3, 0.2], [0.1, 0.9, 0.2, 25.0, 0.7, 0.15]]


def texture(texels=64):
    """The ramp TF sampled at ``texels`` texel centers (JAX)."""
    d = (np.arange(texels) + 0.5) / texels
    return JTex(tensor=jnp.asarray(JTF.make(**RAMP).eval_normalized(
        jnp.asarray(d), None, None, 1.0)))


def jax_tf(mode):
    """(tensor, tf_pre or None) of ``mode`` as numpy arrays."""
    tex = texture()
    if mode == "texture":
        return np.asarray(tex.tensor), None
    if mode == "preint1d":
        return np.asarray(tex.tensor), np.asarray(
            tex.with_preintegration(64).preintegrated)
    if mode == "preint2d":
        return np.asarray(tex.tensor), np.asarray(
            tex.with_preintegration_2d(16, stepsize=H).preintegrated)
    return np.asarray(GAUSSIANS, np.float32), None


def jax_image(engine, mode, jnet, rs, rd, **kw):
    tensor, pre = jax_tf(mode)
    pre = None if pre is None else jnp.asarray(pre)
    if engine == "mega":
        return np.asarray(jmega(rs, rd, jnet, BMIN, BSIZE, tensor,
                                tf_mode=mode, tf_pre=pre, stepsize=H,
                                max_steps=STEPS, seg=SEG, tile=TILE,
                                table_dtype=jnp.float32, interpret=True,
                                **kw))
    lat = dict(latent_mode="boxfeat") if engine == "lattice" else {}
    return np.asarray(jfused(rs, rd, jnet, BMIN, BSIZE, tensor, tf_mode=mode,
                             tf_pre=pre, stepsize=H, max_steps=STEPS,
                             seg=SEG, tile=TILE, interpret=True, **lat, **kw))


def port_image(engine, mode, net, rs, rd, **kw):
    tensor, pre = jax_tf(mode)
    args = (t(rs), t(rd), net, BMIN, BSIZE, t(tensor))
    tf_kw = dict(tf_mode=mode, tf_pre=None if pre is None else t(pre))
    if engine == "mega":
        return mega_trace_dvr_plain(*args, stepsize=H, seg=SEG, tile=TILE,
                                    table_dtype=torch.float32, **tf_kw,
                                    **kw).numpy()
    lat = dict(latent_mode="boxfeat") if engine == "lattice" else {}
    return fused_trace_dvr_plain(*args, stepsize=H, max_steps=STEPS, seg=SEG,
                                 tile=TILE, **tf_kw, **lat, **kw).numpy()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
def test_march_matches_jax(mode, engine):
    """Each TF mode through each plain march against the JAX kernel. In the
    lattice marches (route 1b's engine, the megakernel) rays start past
    their tile's base, so their first sample reads no previous density."""
    jnet = jnet_of(channels=8)
    rs, rd = rays16()
    want = jax_image(engine, mode, jnet, rs, rd)
    got = port_image(engine, mode, port(jnet), rs, rd)
    assert want[:, 3].max() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-4)
    if engine != "segment":
        rays, kbase = fused_dvr._segment_rays(t(rs), t(rd), BMIN, BSIZE, H,
                                              TILE, True, None)
        assert bool((rays[:, 6] > kbase).any())


@pytest.mark.parametrize("mode", ["preint1d", "preint2d"])
def test_prev_chain_crosses_segments(mode):
    """Per-ray sampling does not depend on the segment length, so with no
    early-out the image of 4-sample segments equals that of 32-sample ones
    only if each ray's last density crosses every segment boundary in its
    carry; both match the JAX kernel."""
    jnet = jnet_of(channels=8)
    rs, rd = rays16()
    net = port(jnet)
    tensor, pre = jax_tf(mode)
    kw = dict(stepsize=H, max_steps=64, tile=TILE, enable_early_out=False,
              tf_mode=mode, tf_pre=t(pre))
    short = fused_trace_dvr_plain(t(rs), t(rd), net, BMIN, BSIZE, t(tensor),
                                  seg=4, **kw).numpy()
    long = fused_trace_dvr_plain(t(rs), t(rd), net, BMIN, BSIZE, t(tensor),
                                 seg=32, **kw).numpy()
    np.testing.assert_allclose(short, long, atol=1e-6)
    want = np.asarray(jfused(rs, rd, jnet, BMIN, BSIZE, tensor, tf_mode=mode,
                             tf_pre=jnp.asarray(pre), stepsize=H,
                             max_steps=64, seg=4, tile=TILE,
                             enable_early_out=False, interpret=True))
    np.testing.assert_allclose(short, want, atol=1e-4)


def slow_net():
    """A network whose density varies slowly along the rays: its output
    layer halved around 0.5, so that most, not all, neighbouring samples
    differ by less than 1e-3 (the 1D preintegration's near branch)."""
    jnet = jnet_of(channels=8)
    last = jnet.layers[-1]
    last = last.replace(weight=np.asarray(last.weight, np.float32) / 2,
                        bias=np.asarray([0.5], np.float32))
    return jnet.replace(layers=jnet.layers[:-1] + (last,))


def near_share(net, rs, rd):
    """The share of neighbouring per-ray samples whose normalized
    densities differ by less than 1e-3."""
    rays, _ = fused_dvr._segment_rays(t(rs), t(rd), BMIN, BSIZE, H, TILE,
                                      False, None)
    k = torch.arange(STEPS, dtype=torch.float32)
    tt = rays[:, 6:7] + k * H
    x = (rays[:, None, :3] + tt[..., None] * rays[:, None, 3:6] + 0.5)
    with torch.no_grad():
        d = net(x.reshape(-1, 3))[:, 0].reshape(tt.shape)
    valid = tt <= rays[:, 7:8]
    pair = valid[:, 1:]
    return float(((d[:, 1:] - d[:, :-1]).abs() < 1e-3)[pair].float().mean())


@pytest.mark.parametrize("engine", ["segment", "mega"])
def test_near_branch_matches_jax(engine):
    """The 1D preintegration's near branch (|d - prev| < 1e-3 reads the
    plain table) beside its preintegrated one."""
    jnet = slow_net()
    rs, rd = rays16()
    net = port(jnet)
    assert 0.2 < near_share(net, rs, rd) < 0.95
    want = jax_image(engine, "preint1d", jnet, rs, rd)
    got = port_image(engine, "preint1d", net, rs, rd)
    assert want[:, 3].max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4)


W = 16
RH = 1 / 64
CAM = dict(pitch=0.3, yaw=0.5, distance=1.6)


def models(mode):
    """(JAX model, port model) of the dense flagship with its ramp TF as a
    64-texel texture in ``mode``."""
    _, _, ckpt = jdense_scene()
    tex = texture()
    jtf = {"texture": tex, "preint1d": tex.with_preintegration(128),
           "preint2d": tex.with_preintegration_2d(32, stepsize=RH)}[mode]
    jm = JLoadedModel.from_checkpoint(ckpt, tf=jtf)
    jm.config = JCfg.make(stepsize=RH)
    pre = getattr(jtf, "preintegrated", None)
    tf = TransferFunctionTexture(
        t(jtf.tensor), None if pre is None else t(pre),
        jtf.preintegration_mode)
    _, _, npz = dense_scene()
    m = LoadedModel.from_checkpoint(
        npz, tf=tf, config=RayEvaluationSteppingDvr.make(stepsize=RH))
    return jm, m


@pytest.mark.parametrize("mode,size", [("texture", (W, W)),
                                       ("preint1d", (W, W)),
                                       ("preint2d", (W, W)),
                                       ("preint1d", (24, 20))])
def test_fused_render_matches_jax(mode, size):
    """The product render with each texture TF: route 1 (the megakernel)
    at 16x16 and route 2 (the per-segment engine) at 24x20, against the
    JAX package's FUSED render. preint2d reads the nearest cell, and a
    density on a cell's edge flips with the two packages' rounding of the
    trilerp from the bf16 table (one pixel by 3.3e-4 here): it is held on
    the float32 table."""
    jm, m = models(mode)
    w, h = size
    f32 = mode == "preint2d"
    render = m.prepare_network_render(
        CameraOnASphere.make(**CAM), w, h, "FUSED", device="cpu",
        table_dtype=torch.float32 if f32 else None)
    assert render.route == ("mega" if w % 16 == 0 else "segment")
    assert render.march_kwargs["tf_mode"] == mode
    want = np.asarray(jm.render_network(
        JCam.make(**CAM), w, h, "FUSED", interpret=True,
        table_dtype=jnp.float32 if f32 else None))
    got = render().numpy()
    assert got.shape == (h, w, 4) and want[..., 3].max() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_fused_render_refuses_gaussians():
    """Differs on purpose: the JAX package's FUSED render of a Gaussian TF
    reads its (G, 6) tensor as piecewise knots, an image far from the
    TF's own (PLAIN32); the port's FUSED render refuses it, and renders
    it by PLAIN32."""
    _, _, ckpt = jdense_scene()
    jm = JLoadedModel.from_checkpoint(ckpt, tf=JGauss(
        tensor=jnp.asarray(GAUSSIANS, jnp.float32)))
    jm.config = JCfg.make(stepsize=RH)
    fused = np.asarray(jm.render_network(JCam.make(**CAM), W, W, "FUSED",
                                         interpret=True))
    plain = np.asarray(jm.render_network(JCam.make(**CAM), W, W, "PLAIN32"))
    assert np.abs(fused - plain).max() > 0.1
    _, _, npz = dense_scene()
    m = LoadedModel.from_checkpoint(
        npz, tf=TransferFunctionGaussian(torch.tensor(GAUSSIANS)),
        config=RayEvaluationSteppingDvr.make(stepsize=RH))
    with pytest.raises(NotImplementedError, match="TF mode 'gaussian'"):
        m.prepare_network_render(CameraOnASphere.make(**CAM), W, W, "FUSED",
                                 device="cpu")
    got = m.render_network(CameraOnASphere.make(**CAM), W, W, "PLAIN32",
                           device="cpu").numpy()
    np.testing.assert_allclose(got, plain, atol=1e-4)


def test_saturation_clip_reads_the_previous_density():
    """The saturation probe carries each ray's previous coarse density
    into the TF, as the JAX probe does: a preintegrating TF's clip
    matches the JAX package's (it read none before, and 71 of 256 rays
    clipped elsewhere, by up to 0.5)."""
    from fvsrn_tpu.models.network_volume import \
        VolumeInterpolationNetwork as JVolume
    from fvsrn_tpu.ops.fused_dvr import probe_saturation_tmax as jprobe
    from fvsrn_tpu.raytracer.dvr import max_steps_bound
    jm, m = models("preint1d")
    render = m.prepare_network_render(CameraOnASphere.make(**CAM), W, W,
                                      "FUSED", device="cpu")
    want = jprobe(render.ray_start.numpy(), render.ray_dir.numpy(),
                  JVolume.make(jm.network), jm.tf, stepsize=RH,
                  max_steps=max_steps_bound((1.0, 1.0, 1.0), RH), coarse=8,
                  margin_steps=16)
    np.testing.assert_allclose(render.tmax_clip.numpy(), want, atol=1e-5)
