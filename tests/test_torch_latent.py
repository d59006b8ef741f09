"""Port parity, the latent machinery of time- and ensemble-conditioned
networks (``models/latent.py``, the SRN's time inputs, the weights'
crossing, ensemble generalization and the world step with a gradient
mask): the port against the JAX package on the same numpy-seeded inputs.
Values to 1e-6 and gradients against ``jax.grad`` (the keyframe rule:
floor clipped to the keyframes, an unclipped fraction that extrapolates
below 0; ``interp1d`` clipping its position instead); ``SRN.make`` bit
for bit with time Fourier features; ``generalize_to_new_ensembles`` bit
for bit; the keyframed world step's losses and gradients over 3 steps;
the fused paths' refusals of time inputs (``AssertionError``) and the
screen trainer's fused-route gate over static, keyframed and vector
networks."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvsrn_tpu.models import latent as jlatent
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.train import generalization as jgen
from fvsrn_tpu.train.losses import LossNetWorld as JLoss
from fvsrn_tpu.train.optimizer import make_optimizer as jmake_optimizer
from fvsrn_tpu.train.screen import fused_screen_supported as jsupported
from fvsrn_tpu.train.world import WorldDataset as JWorldDataset
from fvsrn_tpu.train.world import make_train_step as jmake_step
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.models import latent
from fvsrn_tpu_torch.models.latent import LatentSpace
from fvsrn_tpu_torch.models.srn import SceneRepresentationNetwork
from fvsrn_tpu_torch.ops.fused_dvr import fused_trace_dvr_plain
from fvsrn_tpu_torch.ops.fused_eval import make_fused_eval
from fvsrn_tpu_torch.ops.fused_mega import mega_trace_dvr_plain
from fvsrn_tpu_torch.train import generalization
from fvsrn_tpu_torch.train.losses import LossNetWorld
from fvsrn_tpu_torch.train.optimizer import make_optimizer
from fvsrn_tpu_torch.train.screen import fused_screen_supported
from fvsrn_tpu_torch.train.world import WorldDataset, make_train_step
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
TIMES = [0.0, 0.4, 1.0, 2.7, 3.0, 3.5, -0.5]
BOX = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def port(jnet):
    return srn_from_arrays(*network_arrays(jnet))


def keyframed(k_time=3, k_ens=2, c_time=4, c_ens=4, res=6, vectors=False,
              seed=5):
    """The same time-dependent latent space in both packages (numpy
    arrays); with ``vectors`` also latent vectors, which it ignores."""
    rng = np.random.default_rng(seed)
    kw = dict(time_dependent=True)
    if k_time:
        kw["time_grid"] = rng.standard_normal(
            (k_time, c_time, res, res, res)).astype(np.float32)
    if k_ens:
        kw["ensemble_grid"] = rng.standard_normal(
            (k_ens, c_ens, res, res, res)).astype(np.float32)
    if vectors:
        kw["time_vector"] = rng.standard_normal((1, 2, 3)).astype(np.float32)
        kw["ensemble_vector"] = rng.standard_normal((1, 3, 4)).astype(
            np.float32)
    return kw


def port_latent(kw):
    return LatentSpace(**{k: (t(v) if isinstance(v, np.ndarray) else v)
                          for k, v in kw.items()})


def test_interp1d_matches_jax():
    rng = np.random.default_rng(0)
    fp = rng.standard_normal((2, 3, 5)).astype(np.float32)
    x = np.array([[-0.7, 0.0, 0.3, 1.5, 3.99, 4.0, 6.2],
                  [2.5, 0.9, 3.2, 4.5, -2.0, 1.0, 0.1]], np.float32)
    w = rng.standard_normal((2, 3, 7)).astype(np.float32)
    want = np.asarray(jlatent.interp1d(jnp.asarray(fp), jnp.asarray(x)))
    jg = np.asarray(jax.grad(lambda f: jnp.sum(
        jlatent.interp1d(f, jnp.asarray(x)) * w))(jnp.asarray(fp)))
    fpt = t(fp).requires_grad_(True)
    got = latent.interp1d(fpt, t(x))
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    np.testing.assert_allclose(fpt.grad.numpy(), jg, atol=1e-6)


@pytest.mark.parametrize("time", TIMES)
def test_keyframes_match_jax(time):
    """keyframe_grid_sample and keyframe_lerp at ``time`` as a number and
    as a tensor, equal to each other through the trilerp, and their
    gradients, the bracketing keyframes' and exact zeros elsewhere."""
    rng = np.random.default_rng(1)
    grids = rng.standard_normal((4, 3, 5, 6, 7)).astype(np.float32)
    pos = rng.random((37, 3)).astype(np.float32)
    w = rng.standard_normal((37, 3)).astype(np.float32)
    jg, jp = jnp.asarray(grids), jnp.asarray(pos)
    want_s = np.asarray(jlatent.keyframe_grid_sample(jg, jp,
                                                     jnp.float32(time)))
    want_l = np.asarray(jlatent.keyframe_lerp(jg, time))
    want_gs = np.asarray(jax.grad(lambda g: jnp.sum(
        jlatent.keyframe_grid_sample(g, jp, jnp.float32(time)) * w))(jg))
    want_gl = np.asarray(jax.grad(lambda g: jnp.sum(
        jlatent.keyframe_lerp(g, time) ** 2))(jg))
    for at in (time, torch.tensor(time, dtype=torch.float32)):
        g = t(grids).requires_grad_(True)
        got = latent.keyframe_grid_sample(g, t(pos), at)
        (got * t(w)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), want_s, atol=1e-6)
        np.testing.assert_allclose(g.grad.numpy(), want_gs, atol=1e-6)
        g2 = t(grids).requires_grad_(True)
        lerped = latent.keyframe_lerp(g2, at)
        (lerped ** 2).sum().backward()
        np.testing.assert_allclose(lerped.detach().numpy(), want_l,
                                   atol=1e-6)
        np.testing.assert_allclose(g2.grad.numpy(), want_gl, atol=1e-6)
        np.testing.assert_allclose(
            latent.grid_sample_3d(lerped.detach(), t(pos)).numpy(),
            got.detach().numpy(), atol=1e-5)
        lo = int(min(max(np.floor(time), 0), 3))
        outside = [k for k in range(4) if k not in (lo, min(lo + 1, 3))]
        assert float(g.grad[outside].abs().max()) <= 1e-12


@pytest.mark.parametrize("case", ["time", "ensemble", "both", "unequal",
                                  "none", "static"])
def test_resolve_grid_matches_jax(case):
    kw = {"time": keyframed(k_ens=0), "ensemble": keyframed(k_time=0),
          "both": keyframed(), "unequal": keyframed(c_ens=2, res=6),
          "none": dict(time_dependent=True),
          "static": dict(static_grid=np.random.default_rng(2)
                         .standard_normal((5, 4, 4, 4)).astype(np.float32))
          }[case]
    if case == "unequal":
        rng = np.random.default_rng(3)
        kw["ensemble_grid"] = rng.standard_normal((2, 2, 5, 5, 5)).astype(
            np.float32)
        with pytest.raises(ValueError):
            jlatent.resolve_grid(JLatent(**kw), 1.2, 0.5)
        with pytest.raises(ValueError):
            latent.resolve_grid(port_latent(kw), 1.2, 0.5)
        return
    want = jlatent.resolve_grid(JLatent(**kw), 1.7, 0.25)
    got = latent.resolve_grid(port_latent(kw), 1.7, 0.25)
    if want is None:
        assert got is None
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)


@pytest.mark.parametrize("case", ["keyframed", "keyframed_vectors",
                                  "vectors_grid"])
def test_latent_space_evaluate_matches_jax(case):
    rng = np.random.default_rng(4)
    if case == "vectors_grid":
        kw = dict(time_vector=rng.standard_normal((1, 2, 4)).astype(
                      np.float32),
                  ensemble_vector=rng.standard_normal((1, 3, 5)).astype(
                      np.float32),
                  static_grid=rng.standard_normal((4, 5, 5, 5)).astype(
                      np.float32))
    else:
        kw = keyframed(vectors=case == "keyframed_vectors")
    jl, pl = JLatent(**kw), port_latent(kw)
    assert pl.total_channels == jl.total_channels
    x = rng.random((20, 3)).astype(np.float32)
    time = np.linspace(-0.3, 3.4, 20).astype(np.float32)
    ens = np.linspace(0.2, 4.6, 20).astype(np.float32)
    want = jl.evaluate(jnp.asarray(x), jnp.asarray(time), jnp.asarray(ens))
    got = pl.evaluate(t(x), t(time), t(ens))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6)


SRN_CASES = {
    "time_fourier": dict(num_fourier=8, num_time_fourier=3),
    "time_fourier_nerf": dict(num_fourier=8, num_time_fourier=3,
                              fourier_std=-1.0),
    "time_direct": dict(num_fourier=4, use_time_direct=True),
    "time_direct_fourier": dict(num_fourier=6, num_time_fourier=2,
                                use_time_direct=True),
    # tests/test_srn.py:127's network
    "vectors": dict(layers="16", activation="ReLU", num_fourier=2),
    "keyframed": dict(num_fourier=4),
}


@pytest.mark.parametrize("case", sorted(SRN_CASES))
def test_srn_time_inputs_match_jax(case):
    """``make`` bit for bit (the time Fourier matrix from the same
    generator after the position one), the forward at per-sample times
    and ensembles, and the crossing of the weights."""
    rng = np.random.default_rng(6)
    opts = dict(layers="16:16", activation="SnakeAlt:2",
                output_mode="density", seed=9)
    opts.update(SRN_CASES[case])
    lat = {}
    if case == "vectors":
        lat = dict(time_vector=rng.random((1, 2, 4)).astype(np.float32),
                   ensemble_vector=rng.random((1, 3, 5)).astype(np.float32))
    elif case == "keyframed":
        lat = keyframed(res=4)
    jnet = JSRN.make(latent=JLatent(**lat), **opts)
    net = SceneRepresentationNetwork.make(latent=port_latent(lat), **opts)
    arrays, meta = network_arrays(jnet)
    got_arrays = {n: p.detach().numpy() for n, p in net.named_parameters()}
    assert set(got_arrays) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got_arrays[k], v)
    x = rng.random((12, 3)).astype(np.float32)
    time = np.linspace(0, 3, 12).astype(np.float32)
    ens = np.linspace(0, 4, 12).astype(np.float32)
    want = np.asarray(jnet(jnp.asarray(x), time=jnp.asarray(time),
                           ensemble=jnp.asarray(ens)))
    for candidate in (net, srn_from_arrays(arrays, meta)):
        got = candidate(t(x), time=t(time), ensemble=t(ens))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    later = net(t(x), time=t(time + 0.5), ensemble=t(ens))
    assert not np.allclose(later.detach().numpy(), want)


def test_generalization_matches_jax():
    kw = keyframed(k_time=2, k_ens=3, res=8)
    jnet = JSRN.make(layers="16:16", activation="SnakeAlt:1", num_fourier=4,
                     output_mode="density:direct", latent=JLatent(**kw),
                     seed=0)
    net = port(jnet)
    jnew = jgen.generalize_to_new_ensembles(jnet, 5, seed=3)
    new = generalization.generalize_to_new_ensembles(net, 5, seed=3)
    np.testing.assert_array_equal(new.latent.ensemble_grid.detach().numpy(),
                                  np.asarray(jnew.latent.ensemble_grid))
    assert net.latent.ensemble_grid.shape[0] == 3
    for a, b in zip(net.layers, new.layers):
        np.testing.assert_array_equal(a.weight.detach().numpy(),
                                      b.weight.detach().numpy())
    with pytest.raises(ValueError):
        generalization.generalize_to_new_ensembles(
            port(JSRN.make(layers="8", num_fourier=2)), 2)


def _batches(n, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for time, ens in ((0.0, 0.0), (1.0, 2.0), (0.4, 1.5)):
        pos = rng.random((n, 3)).astype(np.float32)
        target = rng.random((n, 1)).astype(np.float32)
        out.append((pos, target, time, ens))
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_keyframed_world_step_matches_jax(masked):
    """Three steps of the keyframed world step (``trainable`` unset) and of
    the latent-only step after ``generalize_to_new_ensembles``: every
    step's loss, and the final parameters, against the JAX package's."""
    kw = keyframed(k_time=2, k_ens=3, res=8)
    jnet = JSRN.make(layers="16:16", activation="SnakeAlt:1", num_fourier=4,
                     output_mode="density:direct", latent=JLatent(**kw),
                     seed=0)
    if masked:
        jnet = jgen.generalize_to_new_ensembles(jnet, 4, std=0.3, seed=1)
    net = port(jnet)
    jopt = jmake_optimizer("Adam", lr=1e-2)
    jstep = jax.jit(jmake_step(JLoss(mode="density", l1=1.0), jopt,
                               trainable=jgen.latent_only_mask if masked
                               else None))
    jstate = jopt.init(jnet)
    step = make_train_step(LossNetWorld(mode="density", l1=1.0),
                           make_optimizer(net.parameters(), "Adam", lr=1e-2),
                           trainable=generalization.latent_only_mask
                           if masked else None)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    for pos, target, time, ens in _batches(512):
        n = pos.shape[0]
        jb = JWorldDataset(jnp.asarray(pos), jnp.asarray(target),
                           jnp.zeros(n), jnp.full((n,), time, jnp.float32),
                           jnp.full((n,), ens, jnp.float32))
        jnet, jstate, jtotal, _ = jstep(jnet, jstate, jb)
        total, _ = step(net, WorldDataset(
            t(pos), t(target), torch.zeros(n), torch.full((n,), time),
            torch.full((n,), ens)))
        np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    arrays = network_arrays(jnet)[0]
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), arrays[name],
                                   atol=2e-5, rtol=1e-4, err_msg=name)
        moved = not torch.equal(p.detach(), before[name])
        assert moved == (not masked or name.startswith("latent.")), name


def test_fused_paths_refuse_time_inputs():
    """Time Fourier features and direct time input raise
    ``AssertionError`` on every fused path, as in the JAX package."""
    rays = torch.zeros(64, 3), torch.ones(64, 3)
    tf = TransferFunctionPiecewiseLinear.make(
        rgb=[[1.0, 1.0, 1.0]] * 2, opacity=[0.0, 5.0], positions=[0.0, 1.0])
    for opts in (dict(num_fourier=6, num_time_fourier=2),
                 dict(num_fourier=4, use_time_direct=True)):
        net = SceneRepresentationNetwork.make(layers="8:8", **opts)
        with pytest.raises(AssertionError):
            fused_trace_dvr_plain(*rays, net, *BOX, tf.tensor,
                                  stepsize=0.1, max_steps=16, tile=64)
        with pytest.raises(AssertionError):
            mega_trace_dvr_plain(*rays, net, *BOX, tf.tensor, stepsize=0.1,
                                 tile=64)
        with pytest.raises(AssertionError):
            make_fused_eval(net, *BOX)


def test_fused_screen_supported_matches_jax():
    """The screen trainer's fused route: keyframed grids train by the
    plain march, latent vectors and static grids fused, in both
    packages."""
    rng = np.random.default_rng(8)
    tf = dict(rgb=[[1.0, 1.0, 1.0]] * 2, opacity=[0.0, 5.0],
              positions=[0.0, 1.0])
    jtf, ptf = JTF.make(**tf), TransferFunctionPiecewiseLinear.make(**tf)
    spaces = {
        "none": {},
        "static": dict(static_grid=rng.random((8, 8, 8, 8)).astype(
            np.float32)),
        "static_wide": dict(static_grid=rng.random((20, 8, 8, 8)).astype(
            np.float32)),
        "time": keyframed(k_ens=0),
        "time_ensemble": keyframed(),
        "ensemble_only": keyframed(k_time=0),
        "vectors": dict(time_vector=rng.random((1, 2, 3)).astype(
            np.float32)),
        "vectors_grid": dict(
            ensemble_vector=rng.random((1, 2, 3)).astype(np.float32),
            static_grid=rng.random((8, 8, 8, 8)).astype(np.float32)),
    }
    seen = set()
    for name, kw in spaces.items():
        jnet = JSRN.make(layers="8:8", num_fourier=2, latent=JLatent(**kw))
        for w, h in ((16, 16), (32, 48), (24, 16)):
            want = jsupported(jnet, jtf, w, h)
            assert fused_screen_supported(port(jnet), ptf, w, h) == want, \
                (name, w, h)
            seen.add(want)
    assert seen == {True, False}
