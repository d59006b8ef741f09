"""Port parity, screen-space training: losses (SSIM/DSSIM included, 1e-6),
the StepLR schedule, fibonacci-sphere cameras (1e-6), every implicit
equation (1e-5), ``SceneRepresentationNetwork.make`` (bit-exact),
``build_screen_dataset`` targets (1e-5) and the whole trainer: the
port's ``train.main.run`` against the JAX ``run`` in screen mode through
the fused march (loss history rtol 1e-4, final parameters per leaf
within a relative norm error of 1e-4). CPU only; the JAX megakernel runs
in Pallas interpret mode."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.camera import fibonacci_sphere_cameras as jfib
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.train import losses as jlosses
from fvsrn_tpu.train import main as jmain
from fvsrn_tpu.train.optimizer import step_lr as jstep_lr
from fvsrn_tpu.train.screen import ScreenDataset as JScreenDataset
from fvsrn_tpu.train.screen import build_screen_dataset as jbuild
from fvsrn_tpu.train.screen import evaluate_screen as jevaluate_screen
from fvsrn_tpu.train.screen import fused_screen_supported as jsupported
from fvsrn_tpu.train.screen import screen_mega_kwargs as jmega_kwargs
from fvsrn_tpu.train.screen import _tf_mode_kwargs as jtf_mode_kwargs
from fvsrn_tpu.transfer import TransferFunctionGaussian as JGauss
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu.transfer import TransferFunctionTexture as JTex
from fvsrn_tpu.volume.implicit import IMPLICIT_EQUATIONS as JEQ
from fvsrn_tpu.volume.implicit import VolumeInterpolationImplicit as JImplicit
from fvsrn_tpu_torch.camera import fibonacci_sphere_cameras, generate_rays
from fvsrn_tpu_torch.models.latent import LatentSpace
from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
from fvsrn_tpu_torch.train import losses, main
from fvsrn_tpu_torch.train.checkpoints import load_arrays, load_weights
from fvsrn_tpu_torch.train.optimizer import make_optimizer, step_lr
from fvsrn_tpu_torch.train.screen import (ScreenDataset,
                                          build_screen_dataset,
                                          evaluate_screen,
                                          fused_screen_supported,
                                          screen_mega_kwargs)
from fvsrn_tpu_torch.ops.fused_dvr import fused_tf_args
from fvsrn_tpu_torch.transfer import (TransferFunctionGaussian,
                                      TransferFunctionPiecewiseLinear,
                                      TransferFunctionTexture)
from fvsrn_tpu_torch.volume.implicit import (IMPLICIT_EQUATIONS,
                                             VolumeInterpolationImplicit)
from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.raytracer.dvr import max_steps_bound
from fvsrn_tpu_torch.convert import srn_from_arrays
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)


def images(seed, shape=(2, 4, 24, 20)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "ssim", "dssim"])
def test_losses(name):
    a, b = images(1)
    want = float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(losses, name)(torch.tensor(a), torch.tensor(b)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(l1=1.0), dict(l1=0.5, l2=2.0, dssim=0.3),
                                dict(l2=1.0, dssim=1.0, multiply_alpha=True)])
def test_loss_net_screen(kw):
    a, b = images(2)
    jt, jv = jlosses.LossNetScreen(**kw)(jnp.asarray(a), jnp.asarray(b),
                                         return_individual=True)
    t, v = losses.LossNetScreen(**kw)(torch.tensor(a), torch.tensor(b),
                                      return_individual=True)
    for key in jv:
        np.testing.assert_allclose(float(v[key]), float(jv[key]), atol=1e-6,
                                   rtol=1e-6, err_msg=key)
    with pytest.raises(NotImplementedError):
        losses.LossNetScreen(lpips=1.0)(torch.tensor(a), torch.tensor(b))


@pytest.mark.parametrize("mode", ["density", "rgbo"])
def test_loss_net_world(mode):
    rng = np.random.default_rng(3)
    c = 1 if mode == "density" else 4
    a, b = (rng.uniform(0, 1, (100, c)).astype(np.float32) for _ in range(2))
    kw = dict(mode=mode, l1=0.7, l2=1.3)
    want = float(jlosses.LossNetWorld(**kw)(jnp.asarray(a), jnp.asarray(b)))
    got = float(losses.LossNetWorld(**kw)(torch.tensor(a), torch.tensor(b)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_step_lr_and_optimizer():
    for args in [(0.01, 500, 0.5), (1e-3, 3, 0.1), (0.2, 2, 0.5, 3)]:
        want, got = jstep_lr(*args), step_lr(*args)
        for n in range(20):
            assert math.isclose(got(n), float(want(n)), rel_tol=1e-12)
    # stepped per update: the lr of update n is step_lr(n)
    p = torch.nn.Parameter(torch.zeros(3))
    opt, sched = make_optimizer([p], "Adam", lr=0.1, lr_step=2, lr_gamma=0.5)
    assert opt.defaults["betas"] == (0.9, 0.999)
    assert opt.defaults["eps"] == 1e-8
    lrs = []
    for _ in range(6):
        lrs.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(3)
        opt.step()
        sched.step()
    np.testing.assert_allclose(lrs, [step_lr(0.1, 2, 0.5)(n)
                                     for n in range(6)], rtol=1e-12)
    for name in ("AdamW", "SGD", "RMSprop"):
        make_optimizer([p], name)
    # L-BFGS: torch's with the strong-Wolfe line search, stepped through a
    # closure (tests/test_torch_stack.py fits with it)
    opt, sched = make_optimizer([p], "lbfgs", lr=0.5)
    assert isinstance(opt, torch.optim.LBFGS)
    assert opt.defaults["line_search_fn"] == "strong_wolfe"
    assert opt.defaults["lr"] == 1.0     # like optax's, it reads no lr


def test_fibonacci_cameras_and_rays():
    jcams = jfib(7, center=(0.1, 0.0, -0.2), distance=1.6)
    cams = fibonacci_sphere_cameras(7, center=(0.1, 0.0, -0.2), distance=1.6)
    np.testing.assert_array_equal(cams.pitch_yaw_distance.numpy(),
                                  np.asarray(jcams.pitch_yaw_distance))
    jrs, jrd = jgenerate_rays(jcams, 12, 8)
    rs, rd = generate_rays(cams, 12, 8, device="cpu")
    assert rs.shape == (7, 8, 12, 3)
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs), atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), atol=1e-6)


@pytest.mark.parametrize("equation", sorted(JEQ))
def test_implicit_equation(equation):
    assert sorted(IMPLICIT_EQUATIONS) == sorted(JEQ)
    pos = np.random.default_rng(4).uniform(-0.6, 0.6, (500, 3)).astype(
        np.float32)
    jv, jin = JImplicit.make(equation).eval_density(jnp.asarray(pos))
    v, inside = VolumeInterpolationImplicit.make(equation).eval_density(
        torch.tensor(pos))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(jin))


@pytest.mark.parametrize("kw", [
    dict(), dict(layers="16:24", activation="ReLU", num_fourier=5,
                 output_mode="rgbo", seed=3),
    dict(num_fourier=8, fourier_std=-1.0, output_mode="density:direct"),
    dict(num_fourier=0, activation="Sine:3", seed=11)])
@pytest.mark.parametrize("channels", [0, 4])
def test_srn_make_bit_exact(kw, channels):
    grid = (np.random.default_rng(0).standard_normal((channels, 4, 5, 6))
            .astype(np.float32) if channels else None)
    jnet = JSRN.make(latent=JLatent(static_grid=grid), **kw)
    net = SceneRepresentationNetwork.make(
        latent=LatentSpace(None if grid is None else torch.tensor(grid)),
        **kw)
    want, _ = network_arrays(jnet)
    got = {n: p.detach().numpy() for n, p in net.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert [(l.activation, l.activation_param) for l in net.layers] == [
        (l.activation, l.activation_param) for l in jnet.layers]


def test_build_screen_dataset():
    rgb, opacity, pos = [[0.9, 0.4, 0.1], [1.0, 1.0, 0.6]], [0.0, 20.0], \
        [0.0, 1.0]
    want = jbuild(JImplicit.make("MARSCHNER_LOBB"), JTF.make(rgb, opacity, pos),
                  JCfg.make(stepsize=1 / 64), num_cameras=3, width=16,
                  height=16)
    got = build_screen_dataset(
        VolumeInterpolationImplicit.make("MARSCHNER_LOBB"),
        TransferFunctionPiecewiseLinear.make(rgb, opacity, pos),
        RayEvaluationSteppingDvr.make(stepsize=1 / 64), num_cameras=3,
        width=16, height=16, render_chunk=100, device="cpu")
    assert float(got.targets[..., 3].max()) > 0.5
    np.testing.assert_allclose(got.ray_start.numpy(),
                               np.asarray(want.ray_start), atol=1e-6)
    np.testing.assert_allclose(got.ray_dir.numpy(), np.asarray(want.ray_dir),
                               atol=1e-6)
    np.testing.assert_allclose(got.targets.numpy(), np.asarray(want.targets),
                               atol=1e-5)


def tf_pair(kind, **gauss):
    """(JAX TF, port TF) of ``kind``: the ramp TF piecewise, as a 16-texel
    texture (plain, preint1d, preint2d) or as two Gaussians (``gauss``:
    their ``analytic`` and ``scale_with_gradient``)."""
    tf = dict(rgb=[[0.9, 0.4, 0.1], [1.0, 1.0, 0.6]], opacity=[0.0, 20.0],
              positions=[0.0, 1.0])
    jtf = JTF.make(**tf)
    if kind == "piecewise":
        return jtf, TransferFunctionPiecewiseLinear.make(**tf)
    if kind == "gaussian":
        g = np.asarray([[0.9, 0.4, 0.1, 10.0, 0.3, 0.2],
                        [1.0, 1.0, 0.6, 20.0, 0.8, 0.1]], np.float32)
        return (JGauss(tensor=jnp.asarray(g), **gauss),
                TransferFunctionGaussian(torch.tensor(g), **gauss))
    d = (np.arange(16) + 0.5) / 16
    jtex = JTex(tensor=jnp.asarray(jtf.eval_normalized(jnp.asarray(d), None,
                                                       None, 1.0)))
    jtex = {"texture": jtex, "preint1d": jtex.with_preintegration(32),
            "preint2d": jtex.with_preintegration_2d(8)}[kind]
    pre = jtex.preintegrated
    return jtex, TransferFunctionTexture(
        torch.tensor(np.asarray(jtex.tensor)),
        None if pre is None else torch.tensor(np.asarray(pre)),
        jtex.preintegration_mode)


@pytest.mark.parametrize("tf_kind", ["piecewise", "texture", "preint1d",
                                     "preint2d", "gaussian"])
@pytest.mark.parametrize("kw,channels,size", [
    (dict(), 0, 16), (dict(), 4, 32), (dict(), 20, 16), (dict(), 4, 24),
    (dict(output_mode="rgbo"), 4, 16),
    (dict(layers="16:24", activation="ReLU", num_fourier=0), 0, 16),
    (dict(), (16, 32), 16), (dict(), (16, 40), 16), (dict(), (16, 64), 16)])
def test_fused_route_matches_jax(kw, channels, size, tf_kind):
    """The trainer sends the same configurations through the fused march
    as the JAX package does, whatever the network, with every TF the
    fused kernels take, and with the same TF mode and table. ``channels``
    is the grid's channels at 4^3, or (channels, resolution): fault F6,
    16-channel grids at 32^3 fit the JAX megakernel's float32 slab, at
    40^3 and 64^3 they do not (zeros: only the shape decides)."""
    res = 4
    if isinstance(channels, tuple):
        channels, res = channels
    shape = (channels, res, res, res)
    grid = ((np.random.default_rng(0).standard_normal(shape) if res == 4
             else np.zeros(shape)).astype(np.float32) if channels else None)
    jnet = JSRN.make(latent=JLatent(static_grid=grid), **kw)
    net = SceneRepresentationNetwork.make(
        latent=LatentSpace(None if grid is None else torch.tensor(grid)),
        **kw)
    jtf, tf = tf_pair(tf_kind)
    want = jsupported(jnet, jtf, size, size)
    assert fused_screen_supported(net, tf, size, size) == want
    jkw = jtf_mode_kwargs(jtf)
    _, got = fused_tf_args(tf)
    assert got.get("tf_mode") == jkw.get("tf_mode")
    if "tf_pre" in jkw:
        np.testing.assert_array_equal(got["tf_pre"].numpy(),
                                      np.asarray(jkw["tf_pre"]))


@pytest.mark.parametrize("gauss", [dict(analytic=True),
                                   dict(scale_with_gradient=True)])
def test_gaussian_variants_train_by_the_plain_march(gauss):
    """Differs on purpose: the JAX package routes an analytic or
    gradient-scaled Gaussian TF into its fused trainer, whose kernels
    evaluate the plain Gaussians instead; the port trains it by the
    plain march (ROADMAP, differs on purpose)."""
    jnet = JSRN.make()
    net = SceneRepresentationNetwork.make()
    jtf, tf = tf_pair("gaussian", **gauss)
    assert jsupported(jnet, jtf, 16, 16)
    assert jtf_mode_kwargs(jtf) == dict(tf_mode="gaussian")
    assert not fused_screen_supported(net, tf, 16, 16)
    assert fused_screen_supported(net, tf_pair("gaussian")[1], 16, 16)


def texture_scene(tmp_path) -> str:
    """A scene JSON of the Marschner-Lobb field under a 16-texel texture
    TF (its stepsize the run's)."""
    import json
    scene = {
        "ImageEvaluator": {"Simple": {
            "selectedCamera": "Sphere", "selectedRayEvaluator": "DVR",
            "selectedVolume": "Implicit"}},
        "RayEvaluation": {"DVR": {"stepsize": 0.03125, "minDensity": 0.0,
                                  "maxDensity": 1.0,
                                  "selectedTF": "Texture"}},
        "camera": {"Sphere": {"center": [0.0, 0.0, 0.0], "distance": 1.7,
                              "pitch": 0.4, "yaw": 0.7}},
        "tf": {"Texture": {
            "absorptionScaling": 20.0,
            "colorPoints": [[0.0, 0.9, 0.4, 0.1], [1.0, 1.0, 1.0, 0.6]],
            "opacityPoints": np.linspace(0.0, 1.0, 16).tolist()}},
        "volume": {"Implicit": {"function": "MarschnerLobb"}}}
    path = tmp_path / "texture.json"
    path.write_text(json.dumps(scene))
    return str(path)


def test_texture_scene_trainer_matches_jax(tmp_path):
    """Screen training on a scene JSON that names a texture TF goes
    through the fused march's texture mode, as in the JAX package: two
    epochs of one 16x16 camera, 1/32, against the JAX trainer. A sigmoid
    head: the random network's direct densities stay below the texture's
    first texel center, where its clamped end has no slope."""
    args = [texture_scene(tmp_path) if a == ARGS[0] else a for a in ARGS]
    args += ["--outputmode", "density"]
    jopt = vars(jmain.init_parser().parse_args(
        [str(tmp_path / "jax.hdf5") if a == "OUT" else a for a in args]))
    want = jmain.run(jopt)
    opt = vars(main.init_parser().parse_args(
        [str(tmp_path / "port.npz") if a == "OUT" else a for a in args]
        + ["--device", "cpu"]))
    got = main.run(opt)
    assert want["fused"] and got["fused"]
    assert got["history"][1] < got["history"][0]
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-4)
    jparams, _ = network_arrays(want["network"])
    for name, p in got["network"].named_parameters():
        rel = (np.linalg.norm(p.detach().numpy() - jparams[name])
               / np.linalg.norm(jparams[name]))
        assert rel <= 1e-4, (name, rel)


ARGS = ["IMPLICIT:MARSCHNER_LOBB", "OUT", "--mode", "screen",
        "--screen_cameras", "1", "--screen_size", "16", "--stepsize",
        "0.03125", "--layers", "32:32:32",
        "--volumetric_features_channels", "4",
        "--volumetric_features_resolution", "8",
        "--volumetric_features_std", "0.3", "-i", "2", "-lr", "0.001",
        "--seed", "5"]


def test_trainer_matches_jax(tmp_path):
    """Two epochs of one 16x16 camera, 1/32, through the fused march."""
    jopt = vars(jmain.init_parser().parse_args(
        [str(tmp_path / "jax.hdf5") if a == "OUT" else a for a in ARGS]))
    want = jmain.run(jopt)
    out = tmp_path / "port.npz"
    opt = vars(main.init_parser().parse_args(
        [str(out) if a == "OUT" else a for a in ARGS] + ["--device", "cpu"]))
    got = main.run(opt)
    assert want["fused"] and got["fused"]
    assert len(got["history"]) == 2 and got["history"][1] < got["history"][0]
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-4)
    jparams, _ = network_arrays(want["network"])
    params = {n: p.detach().numpy()
              for n, p in got["network"].named_parameters()}
    assert sorted(params) == sorted(jparams)
    for name in jparams:
        rel = (np.linalg.norm(params[name] - jparams[name])
               / np.linalg.norm(jparams[name]))
        assert rel <= 1e-4, (name, rel)
    # the run file reads back as the trained network
    arrays, meta = load_arrays(str(out))
    assert meta["history"] == got["history"] and meta["options"]["seed"] == 5
    back = load_weights(str(out))
    for name, p in back.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[name])


@pytest.mark.parametrize("extra", [["-o", "LBFGS"],
                                   ["--data_parallel", "2"],
                                   ["--tensorboard", "tb"]])
def test_trainer_rejects_what_is_not_ported(extra, tmp_path, monkeypatch):
    """What the trainer refuses of these options, now that each is
    ported: ``--optimizer lbfgs`` (its steps pass no closure; the JAX
    trainer fails at its first update) and ``--data_parallel 2`` with one
    camera (not a multiple of the ranks, as the JAX trainer) raise
    ``ValueError`` before any rendering; ``--tensorboard`` is refused
    nothing (tests/test_torch_stack.py logs through it): a run with its
    writer stubbed goes on to its end."""
    args = [str(tmp_path / "x.npz") if a == "OUT" else a for a in ARGS]
    if extra[0] == "--tensorboard":
        extra = ["--tensorboard", str(tmp_path / "tb"), "-i", "1"]
    opt = vars(main.init_parser().parse_args(args + extra
                                             + ["--device", "cpu"]))
    if extra[0] != "--tensorboard":
        with pytest.raises(ValueError):
            main.run(opt)
        assert not (tmp_path / "x.npz").exists()
        return
    import sys
    import types
    writes = []
    monkeypatch.setitem(
        sys.modules, "torch.utils.tensorboard", types.SimpleNamespace(
            SummaryWriter=lambda d: types.SimpleNamespace(
                add_scalar=lambda *a: writes.append(a), close=lambda: None)))
    out = main.run(opt)
    assert writes == [("loss/total", out["history"][0], 0)]


# the networks of the paper's sweeps the trainer's options express (no
# option gives direction input: test_evaluate_screen_engine_matches_jax)
NETWORK_ARGS = {
    "rgbo": ["--outputmode", "rgbo"],
    "rgbo_texture": ["--outputmode", "rgbo"],
    "rgbo_exp": ["--outputmode", "rgbo:exp"],
    "width48": ["--layers", "48:48:48", "--outputmode", "density"],
    "width64": ["--layers", "64:64", "--outputmode", "density"],
    "relu": ["--activation", "ReLU", "--outputmode", "density"],
    "sine3": ["--activation", "Sine:3", "--outputmode", "density"],
    "snake1": ["--activation", "Snake:1", "--outputmode", "density"],
    "sigmoid": ["--activation", "Sigmoid", "--outputmode", "density"],
    "softplus": ["--activation", "Softplus", "--outputmode", "density"],
}


@pytest.mark.parametrize("case", sorted(NETWORK_ARGS))
def test_network_trainer_matches_jax(case, tmp_path):
    """The sweeps' networks train through the fused march (the
    megakernel) as in the JAX package: color outputs (whose head reads no
    TF, also under a texture TF), widths 48 and 64, every activation;
    two epochs of one 16x16 camera, 1/32, against the JAX trainer (loss
    history rtol 1e-4, parameters 1e-4). A sigmoid density head keeps a
    random network's samples contributing."""
    args = list(ARGS) + NETWORK_ARGS[case]
    if case == "rgbo_texture":
        args[0] = texture_scene(tmp_path)
    jopt = vars(jmain.init_parser().parse_args(
        [str(tmp_path / "jax.hdf5") if a == "OUT" else a for a in args]))
    want = jmain.run(jopt)
    opt = vars(main.init_parser().parse_args(
        [str(tmp_path / "port.npz") if a == "OUT" else a for a in args]
        + ["--device", "cpu"]))
    got = main.run(opt)
    assert want["fused"] and got["fused"]
    assert got["history"][1] < got["history"][0]
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-4)
    jparams, _ = network_arrays(want["network"])
    for name, p in got["network"].named_parameters():
        rel = (np.linalg.norm(p.detach().numpy() - jparams[name])
               / np.linalg.norm(jparams[name]))
        assert rel <= 1e-4, (name, rel)


def f4_case(channels=8, res=8, **net_kw):
    """Fault F4's setup: a seeded 32:32:32 SnakeAlt:2 network (6 Fourier
    features, 8-channel 8^3 grid or ``channels`` x ``res``^3, seed 7;
    ``net_kw`` more ``make`` options), one 16x16 camera, h = 1/32, L1
    against a zero target. Returns (JAX args, port args) of
    ``evaluate_screen`` up to ``use_fused``/``fused_kwargs``, and the two
    datasets."""
    rng = np.random.default_rng(7)
    grid = (rng.standard_normal((channels, res, res, res)) * 0.3).astype(
        np.float32)
    jnet = JSRN.make(**dict(dict(layers="32:32:32", activation="SnakeAlt:2",
                                 num_fourier=6, output_mode="density:direct",
                                 latent=JLatent(static_grid=grid), seed=7),
                            **net_kw))
    rs, rd = jgenerate_rays(JCam.make(pitch=0.3, yaw=0.8, distance=1.6), 16,
                            16)
    rs = np.asarray(rs).reshape(1, -1, 3)
    rd = np.asarray(rd).reshape(1, -1, 3)
    tgt = np.zeros((1, 256, 4), np.float32)
    tf = dict(rgb=[[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9]],
              opacity=[2.0, 10.0, 30.0], positions=[0.0, 0.45, 1.0])
    h = 1 / 32
    steps = max_steps_bound((1.0, 1.0, 1.0), h)
    jargs = (jnet, jnp.asarray(rs), jnp.asarray(rd), jnp.asarray(tgt),
             JTF.make(**tf), JCfg.make(stepsize=h),
             jlosses.LossNetScreen(l1=1.0), steps, 16, 16)
    net = srn_from_arrays(*network_arrays(jnet))
    args = (net, torch.tensor(rs), torch.tensor(rd), torch.tensor(tgt),
            TransferFunctionPiecewiseLinear.make(**tf),
            RayEvaluationSteppingDvr.make(stepsize=h),
            losses.LossNetScreen(l1=1.0), steps, 16, 16)
    return (jargs, args, JScreenDataset(*jargs[1:4], 16, 16),
            ScreenDataset(*args[1:4], 16, 16))


def f4_loss_and_grads(jargs, args, jfk, fk):
    """(JAX loss, grads), (port loss, grads) of one ``evaluate_screen``."""
    def jloss(net):
        return jevaluate_screen(net, *jargs[1:], use_fused=True,
                                fused_kwargs=jfk)[0]

    jl, jg = jax.value_and_grad(jloss)(jargs[0])
    net = args[0]
    net.zero_grad(set_to_none=True)
    total, _ = evaluate_screen(*args, use_fused=True, fused_kwargs=fk)
    total.backward()
    return ((float(jl), network_arrays(jg)[0]),
            (float(total.detach()),
             {n: p.grad.numpy() for n, p in net.named_parameters()}))


@pytest.mark.parametrize("engine", ["scan", "mega", "mega_direction"])
def test_evaluate_screen_engine_matches_jax(engine):
    """Fault F4: ``evaluate_screen(use_fused=True)`` takes the JAX
    package's engine: the per-segment scan by default (no early-out),
    the megakernel only with ``engine="mega"``
    (``screen_mega_kwargs``); loss rtol 1e-5, gradients atol 2e-5 / rtol
    1e-3. The parent sent the default call to the megakernel with its
    tile vote, 4.0e-3 off the JAX loss here. "mega_direction": a network
    with direction input (in the Fourier features too) on the megakernel,
    a sigmoid density head."""
    jargs, args, jds, ds = (f4_case(use_direction=True,
                                    disable_direction_in_fourier=False,
                                    output_mode="density")
                            if engine == "mega_direction" else f4_case())
    if engine == "scan":
        jfk, fk = dict(interpret=True), None
    else:
        h, steps = float(np.asarray(jargs[5].stepsize)), jargs[7]
        jfk = dict(jmega_kwargs(jds, jargs[0], stepsize=h, max_steps=steps,
                                interpret=True), enable_early_out=False)
        fk = dict(screen_mega_kwargs(ds), enable_early_out=False)
    (jl, jg), (loss, grads) = f4_loss_and_grads(jargs, args, jfk, fk)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert sorted(grads) == sorted(jg)
    for name in jg:
        assert np.abs(jg[name]).max() > 0, name
        np.testing.assert_allclose(grads[name], jg[name], atol=2e-5,
                                   rtol=1e-3, err_msg=name)
    if engine == "scan":
        # the parent's route for the default call: the megakernel, rays
        # in row-major order, the tile vote on
        with torch.no_grad():
            parent, _ = evaluate_screen(*args, use_fused=True,
                                        fused_kwargs=dict(engine="mega"))
        assert abs(float(parent) - jl) > 1e-3


def test_fault_f6_slab_budget_matches_jax():
    """Fault F6: the fused-training gate holds a grid to the JAX
    megakernel's float32 slab budget, as the JAX gate does
    (``fvsrn_tpu/train/screen.py:fused_screen_supported``). A 16x48^3
    grid fails it, so both packages train by the plain march and
    ``evaluate_screen`` gives the same loss (rtol 1e-5) and gradients
    (atol 2e-5 / rtol 1e-3). The parent took the fused lattice march
    there (the trainer's megakernel), 8.4e-3 relative off the JAX loss;
    now 4.3e-7."""
    jargs, args, jds, ds = f4_case(channels=16, res=48)
    assert not jsupported(jargs[0], jargs[4], 16, 16)
    assert not fused_screen_supported(args[0], args[4], 16, 16)
    (jl, jg), (loss, grads) = f4_loss_and_grads_plain(jargs, args)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert sorted(grads) == sorted(jg)
    for name in jg:
        np.testing.assert_allclose(grads[name], jg[name], atol=2e-5,
                                   rtol=1e-3, err_msg=name)
    with torch.no_grad():   # the parent's route: the fused megakernel
        parent, _ = evaluate_screen(*args, use_fused=True,
                                    fused_kwargs=screen_mega_kwargs(ds))
    assert abs(float(parent) - jl) > 1e-3 * abs(jl)


def f4_loss_and_grads_plain(jargs, args):
    """(JAX loss, grads), (port loss, grads) of one ``evaluate_screen`` by
    the plain march (``use_fused=False``)."""
    def jloss(net):
        return jevaluate_screen(net, *jargs[1:], use_fused=False)[0]

    jl, jg = jax.value_and_grad(jloss)(jargs[0])
    net = args[0]
    net.zero_grad(set_to_none=True)
    total, _ = evaluate_screen(*args, use_fused=False)
    total.backward()
    return ((float(jl), network_arrays(jg)[0]),
            (float(total.detach()),
             {n: p.grad.numpy() for n, p in net.named_parameters()}))
