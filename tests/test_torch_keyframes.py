"""Port parity, the fused paths on time- and ensemble-conditioned networks
(TPU kernel rows 1-7 through ``ops.fused_dvr.resolve_network``: keyframed
grids lerped into one static grid, latent vectors folded into layer 0's
bias). The plain versions of the two engines (``fused_trace_dvr_plain``
per ray, ``mega_trace_dvr_plain`` on the lattice) against the JAX
package's plain ``trace_dvr`` on ``VolumeInterpolationNetwork.make(net,
time=t, ensemble=e)`` (``lattice`` as the megakernel samples), 16², h =
1/32: images to atol 1e-4, the keyframes' and vectors' gradients to atol
2e-5 / rtol 1e-3 against ``jax.grad`` (tests/test_fused.py's contract),
keyframes outside the bracket to 1e-12; row 7's plain version against the
JAX ``make_fused_eval`` in interpret mode; ``trace_mc`` on BASELINE
config 5's network (tests/test_parallel.py:274) against JAX's, fused and
plain, >= 98% of the rays within 1e-3; and the FUSED render's route
choice on the resolved grid. The CUDA kernels are held against these
plain versions on the card by tests/test_torch_kernels.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import VolumeInterpolationNetwork as JVol
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.ops.fused_eval import make_fused_eval as jmake_eval
from fvsrn_tpu.phase import PhaseFunctionRayleigh as JRayleigh
from fvsrn_tpu.raytracer import montecarlo as jmc
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import max_steps_bound
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace_dvr
from fvsrn_tpu_torch.camera import CameraOnASphere
from fvsrn_tpu_torch.inference import LoadedModel
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.ops.fused_dvr import (NetworkView,
                                           fused_trace_dvr_plain,
                                           resolve_network)
from fvsrn_tpu_torch.ops.fused_eval import make_fused_eval
from fvsrn_tpu_torch.ops.fused_mega import mega_trace_dvr_plain
from fvsrn_tpu_torch.phase import PhaseFunctionRayleigh
from fvsrn_tpu_torch.raytracer import montecarlo as tmc
from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from fvsrn_tpu_torch.utils import prng
from tests.test_torch_segment import BMIN, BSIZE, RAMP, port, rays16, t, tfs
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-3
H = 1 / 32
STEPS = max_steps_bound(BSIZE, H)


def scene(kind):
    """The JAX network of a case: SnakeAlt:2, 6 Fourier features,
    ``density:direct``; 32:32:32 with keyframed grids (tests/test_fused.py's
    ``_time_scene``), 32:32 with latent vectors (its latent-vector test's
    network, seed 17)."""
    vectors = kind.startswith("vectors")
    seed = 17 if vectors else 11
    rng = np.random.default_rng(seed)

    def grids(k, c):
        return (rng.standard_normal((k, c, 8, 8, 8)) * 0.3).astype(
            np.float32)

    if kind == "time":
        lat = JLatent(time_grid=grids(3, 8), time_dependent=True)
    elif kind == "time_ensemble":
        lat = JLatent(time_grid=grids(2, 4), ensemble_grid=grids(2, 4),
                      time_dependent=True)
    else:
        lat = JLatent(
            time_vector=rng.standard_normal((1, 4, 3)).astype(np.float32),
            ensemble_vector=rng.standard_normal((1, 2, 3)).astype(
                np.float32),
            static_grid=((rng.standard_normal((8, 8, 8, 8)) * 0.3).astype(
                np.float32) if kind == "vectors_grid" else None))
    return JSRN.make(layers="32:32" if vectors else "32:32:32",
                     activation="SnakeAlt:2",
                     num_fourier=6, output_mode="density:direct",
                     latent=lat, seed=seed)


_ORACLES = {}


def oracle(lattice):
    """JAX's plain ``trace_dvr`` of the 16² rays, jitted once a lattice
    mode (time and ensemble are leaves of the volume)."""
    if lattice not in _ORACLES:
        rs, rd = rays16()
        jtf, _ = tfs(RAMP)
        cfg = JCfg.make(stepsize=H, enable_early_out=False)
        _ORACLES[lattice] = jax.jit(lambda vol: jtrace_dvr(
            rs, rd, vol, jtf, cfg, STEPS, lattice=lattice).color)
    return _ORACLES[lattice]


def march(engine, net, tf, **kw):
    rs, rd = rays16()
    if engine == "segment":
        return fused_trace_dvr_plain(t(rs), t(rd), net, BMIN, BSIZE, tf,
                                     stepsize=H, max_steps=STEPS, seg=16,
                                     tile=64, enable_early_out=False, **kw)
    return mega_trace_dvr_plain(t(rs), t(rd), net, BMIN, BSIZE, tf,
                                stepsize=H, seg=16, tile=64,
                                enable_early_out=False,
                                table_dtype=torch.float32, **kw)


FWD_CASES = {
    "time_0": ("time", 0.0, 0.0),
    "time_1.3": ("time", 1.3, 0.0),
    "time_2": ("time", 2.0, 0.0),
    "time_ensemble": ("time_ensemble", 0.6, 1.0),
    "vectors": ("vectors", 0.37, 0.81),
    "vectors_grid": ("vectors_grid", 0.37, 0.81),
}


@pytest.mark.parametrize("engine", ["segment", "mega"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_fused_plain_matches_jax_oracle(case, engine):
    kind, time, ens = FWD_CASES[case]
    jnet = scene(kind)
    _, tf = tfs(RAMP)
    lattice = engine == "mega"
    want = np.asarray(oracle(lattice)(JVol.make(jnet, time=time,
                                                ensemble=ens)))
    got = march(engine, port(jnet), tf.tensor, time=time, ensemble=ens)
    assert want[:, 3].max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


GRAD_CASES = {
    # keyframes 0 and 1 bracket t = 0.7, keyframe 2 stays out
    "time": ("time", 0.7, 0.0, ["time_grid"], {"time_grid": [2]}),
    "time_ensemble": ("time_ensemble", 0.6, 1.0,
                      ["time_grid", "ensemble_grid"], {}),
    "vectors": ("vectors", 0.37, 0.81, ["time_vector", "ensemble_vector"],
                {}),
    "vectors_grid": ("vectors_grid", 0.37, 0.81,
                     ["time_vector", "ensemble_vector", "static_grid"], {}),
}


@pytest.mark.parametrize("case,engine", [
    ("time", "segment"), ("time", "mega"), ("time_ensemble", "mega"),
    ("vectors", "segment"), ("vectors_grid", "mega")])
def test_fused_plain_latent_gradients_match_jax(case, engine):
    """The differentiable plain marches chain the gradient through the
    resolve into both bracketing keyframes and through the bias fold into
    the vectors; keyframes outside the bracket get exactly zero."""
    kind, time, ens, leaves, outside = GRAD_CASES[case]
    jnet = scene(kind)
    jtf, tf = tfs(RAMP)
    lattice = engine == "mega"
    rs, rd = rays16()
    target = np.random.default_rng(5).random((rs.shape[0], 4)).astype(
        np.float32)
    cfg = JCfg.make(stepsize=H, enable_early_out=False)

    def jloss(net):
        out = jtrace_dvr(rs, rd, JVol.make(net, time=time, ensemble=ens),
                         jtf, cfg, STEPS, lattice=lattice).color
        return jnp.mean((out - target) ** 2)

    jgrads = jax.grad(jloss)(jnet).latent
    net = port(jnet)
    out = march(engine, net, tf.tensor, time=time, ensemble=ens,
                differentiable=True)
    ((out - t(target)) ** 2).mean().backward()
    for name in leaves:
        got = getattr(net.latent, name).grad.numpy()
        want = np.asarray(getattr(jgrads, name))
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    for name, frames in outside.items():
        g = getattr(net.latent, name).grad[frames]
        assert float(g.abs().max()) <= 1e-12, name
    # every other parameter trains through the view too
    assert net.layers[0].weight.grad.abs().max() > 0


def test_view_keeps_the_graph():
    """The view's grid and folded bias are plain tensors in autograd's
    graph (a Parameter built from the resolved grid would cut it)."""
    keyframed = resolve_network(port(scene("time")), 0.5)
    assert keyframed.latent.static_grid.grad_fn is not None
    net = port(scene("vectors_grid"))
    view = resolve_network(net, 0.5, 1.5)
    assert isinstance(view, NetworkView)
    assert view.latent.static_grid is net.latent.static_grid
    assert view.layers[0].bias.grad_fn is not None
    assert view.layers[0].weight.shape[1] == (
        net.layers[0].weight.shape[1] - 6)
    assert resolve_network(view) is view
    plain = port(JSRN.make(layers="8:8", num_fourier=2))
    assert resolve_network(plain) is plain


@pytest.mark.parametrize("kind", ["time_ensemble", "vectors_grid"])
def test_fused_eval_plain_matches_jax(kind):
    """Row 7's plain version at (1.3, 0.5) against the JAX evaluator in
    Pallas interpret mode, values and position gradients."""
    jnet = scene(kind)
    net = port(jnet)
    rng = np.random.default_rng(2)
    pos = (rng.random((300, 3)).astype(np.float32) * 1.2 - 0.6)
    kw = dict(time=1.3, ensemble=0.5)
    v, inside, g = make_fused_eval(net, BMIN, BSIZE, want_grad=True,
                                   **kw)(t(pos))
    jv, jin, jg = jmake_eval(jnet, BMIN, BSIZE, tile=128, want_grad=True,
                             interpret=True, **kw)(jnp.asarray(pos))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(jin))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=2e-5)
    sel = inside.numpy()
    np.testing.assert_allclose(g.numpy()[sel], np.asarray(jg)[sel],
                               atol=5e-4, rtol=1e-3)
    # and against the network volume at the same conditioning
    want, _ = VolumeInterpolationNetwork(net, BMIN, BSIZE,
                                         **kw).eval_density(t(pos))
    np.testing.assert_allclose(v.numpy(), want.detach().numpy(), atol=2e-5)


def config5():
    """BASELINE config 5's network at 16² (tests/test_parallel.py:274):
    16:16 SnakeAlt:2, 4 Fourier features, a 3-keyframe 8-channel time
    grid, t = 1.3, Rayleigh, one bounce."""
    rng = np.random.default_rng(1234)
    lat = JLatent(time_dependent=True, time_grid=(
        rng.standard_normal((3, 8, 8, 8, 8)) * 0.3).astype(np.float32))
    return JSRN.make(layers="16:16", activation="SnakeAlt:2", num_fourier=4,
                     output_mode="density:direct", latent=lat, seed=4)


def test_trace_mc_config5_matches_jax():
    tfk = dict(rgb=[[0.9, 0.3, 0.2], [0.2, 0.6, 1.0]], opacity=[2.0, 15.0],
               positions=[0.0, 1.0])
    jnet = config5()
    jtf, tf = tfs(tfk)
    rs, rd = rays16()
    time = 1.3
    jcfg = jmc.RayEvaluationMonteCarlo.make(
        max_absorption=float(np.asarray(jtf.max_absorption())),
        max_iterations=32, num_bounces=1)
    cfg = tmc.RayEvaluationMonteCarlo.make(
        max_absorption=float(tf.max_absorption()), max_iterations=32,
        num_bounces=1)
    rid = np.arange(rs.shape[0], dtype=np.uint32)
    want = np.asarray(jmc.trace_mc(
        jax.random.PRNGKey(11), rs, rd, JVol.make(jnet, time=time), jtf,
        JRayleigh.make(), jcfg, ray_id=jnp.asarray(rid)).color)
    assert np.isfinite(want).all() and want[:, 3].max() > 0.1
    vol = VolumeInterpolationNetwork(port(jnet), time=time)
    for fused in (False, True):
        got = tmc.trace_mc(prng.prng_key(11), t(rs), t(rd), vol, tf,
                           PhaseFunctionRayleigh.make(), cfg,
                           ray_id=torch.arange(rs.shape[0]),
                           use_fused=fused).color.numpy()
        close = np.all(np.abs(got - want) < 1e-3, axis=-1)
        assert close.mean() >= 0.98, (fused, (~close).sum())


@pytest.mark.parametrize("channels,route", [((8, 8), "mega"),
                                            ((16, 8), "segment"),
                                            (None, "segment")])
def test_fused_route_on_resolved_grid(channels, route):
    """The FUSED render routes by the grid resolved at (0, 0): time and
    ensemble grids of 8 + 8 channels take the megakernel, 16 + 8 the
    per-segment engine, latent vectors alone too; the frame is the
    march's at time 0, ensemble 0."""
    rng = np.random.default_rng(3)
    if channels is None:
        lat = JLatent(time_vector=rng.standard_normal((1, 4, 3)).astype(
            np.float32))
    else:
        lat = JLatent(
            time_grid=(rng.standard_normal((3, channels[0], 4, 4, 4))
                       * 0.3).astype(np.float32),
            ensemble_grid=(rng.standard_normal((2, channels[1], 4, 4, 4))
                           * 0.3).astype(np.float32), time_dependent=True)
    jnet = JSRN.make(layers="16:16", activation="SnakeAlt:2", num_fourier=4,
                     output_mode="density:direct", latent=lat, seed=3)
    _, tf = tfs(RAMP)
    model = LoadedModel(port(jnet), tf,
                        config=RayEvaluationSteppingDvr.make(stepsize=H))
    render = model.prepare_network_render(
        CameraOnASphere.make(pitch=0.3, yaw=0.8, distance=1.6), 16, 16,
        "FUSED", device="cpu")
    assert render.route == route
    img = render()
    assert img.shape == (16, 16, 4) and torch.isfinite(img).all()
    assert img[..., 3].max() > 0.05
    raw = render.march()
    np.testing.assert_array_equal(render.march(time=0.0).numpy(),
                                  raw.numpy())
    assert (render.march(time=1.5) - raw).abs().max() > 1e-4
