"""Port parity, TFs of any size on TPU kernel rows 1-6: piecewise TFs of 17
and 40 knots and a Gaussian TF of 24 components, more than the kernels
stage in shared memory (``ops.sample_mlp.TF_STAGED_POINTS``; above it they
read the TF from device memory). The port's plain versions (what every
kernel is held to on the card) on the same numpy-seeded network, rays, TF
and cotangent as the JAX package, at 16^2 rays (four 64-ray tiles),
stepsize 1/32 and 8-sample segments, every knot and Gaussian over the
network's densities:

- the render of both engines (``mega_trace_dvr``, ``fused_trace_dvr``)
  against the JAX kernels in Pallas interpret mode: image atol 1e-4;
- the differentiable pair of both engines (no early-out) against
  autodiff of the JAX package's plain march (``trace_dvr``, on the
  lattice for the megakernel), as tests/test_fused.py holds the JAX
  kernels' custom VJPs: image atol 1e-4, every gradient leaf (the TF's
  included, every knot or Gaussian of it nonzero) atol 2e-5 / rtol 1e-3.
  The JAX kernels evaluate SnakeAlt and the Fourier features with a
  polynomial sine (max error 5.9e-6, fvsrn_tpu/ops/fused_dvr.py:208):
  under 24 Gaussians that moves their VJPs 2.5-6.4x the contract off the
  port's plain pair, and at 40 knots their VJPs take 90-120 s each in
  interpret mode, so autodiff of the plain march is the reference;
- the kernels' checks take every count, and the plans count no TF float
  above ``TF_STAGED_POINTS`` points.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_kernels.py (``-k knots``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.models.network_volume import VolumeInterpolationNetwork as JVol
from fvsrn_tpu.ops.fused_dvr import fused_trace_dvr as jfused
from fvsrn_tpu.ops.fused_mega import mega_trace_dvr as jmega
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace
from fvsrn_tpu.transfer import TransferFunctionGaussian as JGauss
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch.ops import fused_dvr, fused_mega, sample_mlp
from fvsrn_tpu_torch.ops.fused_dvr import fused_trace_dvr_plain
from fvsrn_tpu_torch.ops.fused_mega import mega_trace_dvr_plain
from tests.test_torch_segment import BMIN, BSIZE, jnet_of, port, rays16, t
from tests.test_torch_tf_modes import H, SEG, STEPS, TILE
from tests.test_torch_tf_modes_grad import check
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
ENGINES = ("segment", "mega")
TFS = ("knots17", "knots40", "gauss24")
# the random network's densities (SnakeAlt, density:direct) lie in [0,
# ~0.025]: the TFs place their knots and Gaussians there, as a user does on
# a volume's histogram, so that every interval holds samples, with the
# slopes of the tests' ramp TF (RAMP: ~18 absorption and ~2 color a unit
# of density)
SPAN = 0.03


def knots(n, seed):
    """A piecewise TF of ``n`` knots: -SPAN / 10 and n - 1 jittered evenly
    spaced positions in (0, SPAN]; a color ripple of 0.02 and an
    absorption of 2 rising by 18 a unit of density, each value with a
    seeded 2% ripple. The first knot lies below the clipped densities'
    floor (0, where the density:direct head puts every clipped sample):
    on a knot the kernels' subgradient (knot positions strictly inside
    the interval) and autodiff's differ."""
    rng = np.random.default_rng(seed)
    inner = np.linspace(0.0, SPAN, n)[1:]
    inner += rng.uniform(-0.3, 0.3, n - 1) * SPAN / (n - 1)
    pos = np.concatenate([[-0.1 * SPAN], inner])
    phase = 2.0 * np.pi * pos / SPAN
    rgb = np.column_stack([0.5 + 0.02 * np.sin(phase), 0.4 + 2.0 * pos,
                           0.6 - 2.0 * pos])
    absn = 2.0 + 18.0 * pos
    vals = np.column_stack([rgb, absn]) * (1.0 + 0.02 * rng.uniform(
        -1, 1, (n, 4)))
    return np.column_stack([vals, pos]).astype(np.float32)


def gaussians(n, seed):
    """``n`` Gaussians [r, g, b, opacity, mean, sigma]: means evenly
    spaced over [0, SPAN] and jittered, sigmas 0.4 SPAN, opacities 0.1 to
    0.2 (their sum about the ramp's absorption there)."""
    rng = np.random.default_rng(seed)
    mean = np.linspace(0.0, SPAN, n) + rng.uniform(-0.1, 0.1, n) * SPAN / n
    return np.column_stack([rng.uniform(0.3, 0.7, (n, 3)),
                            rng.uniform(0.1, 0.2, n), mean,
                            np.full(n, 0.4 * SPAN)]).astype(np.float32)


def tf_of(name):
    """(numpy tensor, tf_mode) of ``name``."""
    if name == "gauss24":
        return gaussians(24, 5), "gaussian"
    return knots(int(name[5:]), 3), "piecewise"


def jax_march(engine, jnet, rs, rd, tensor, mode):
    """The JAX kernel of ``engine`` in Pallas interpret mode."""
    kw = dict(stepsize=H, max_steps=STEPS, seg=SEG, tile=TILE,
              tf_mode=mode, interpret=True)
    if engine == "mega":
        return jmega(rs, rd, jnet, BMIN, BSIZE, tensor,
                     table_dtype=jnp.float32, **kw)
    return jfused(rs, rd, jnet, BMIN, BSIZE, tensor, **kw)


def port_march(engine, net, rs, rd, tensor, mode, **kw):
    kw = dict(stepsize=H, seg=SEG, tile=TILE, tf_mode=mode, **kw)
    if engine == "mega":
        return mega_trace_dvr_plain(rs, rd, net, BMIN, BSIZE, tensor,
                                    table_dtype=torch.float32, **kw)
    return fused_trace_dvr_plain(rs, rd, net, BMIN, BSIZE, tensor,
                                 max_steps=STEPS, **kw)


@pytest.mark.parametrize("tf", TFS)
@pytest.mark.parametrize("engine", ENGINES)
def test_render_matches_jax(engine, tf):
    """Rows 1 and 4: the plain march against the JAX kernels, which loop
    over any number of knots or Gaussians."""
    jnet = jnet_of(channels=8)
    tensor, mode = tf_of(tf)
    rs, rd = rays16()
    want = np.asarray(jax_march(engine, jnet, rs, rd, jnp.asarray(tensor),
                                mode))
    got = port_march(engine, port(jnet), t(rs), t(rd), t(tensor), mode)
    assert want[:, 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("tf", TFS)
@pytest.mark.parametrize("engine", ENGINES)
def test_training_matches_jax(engine, tf):
    """Rows 2-3 and 5-6: the plain differentiable pair (no early-out)
    against autodiff of the JAX plain march, loss = sum(w * rgba): image
    and every leaf, the TF's gradient over every knot or Gaussian."""
    jnet = jnet_of(channels=8)
    tensor, mode = tf_of(tf)
    rs, rd = rays16()
    w = np.random.default_rng(11).uniform(-1, 1, (rs.shape[0], 4)).astype(
        np.float32)
    cfg = JCfg.make(stepsize=H, enable_early_out=False)

    jtf = JGauss if mode == "gaussian" else JTF

    def jloss(net, a):
        img = jtrace(jnp.asarray(rs), jnp.asarray(rd), JVol.make(net),
                     jtf(tensor=a), cfg, STEPS,
                     lattice=engine == "mega").color
        return jnp.sum(img * w), img

    (_, jimg), (gnet, ga) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnet, jnp.asarray(tensor))
    jgrads, _ = network_arrays(gnet)
    jgrads["tf"] = np.asarray(ga)
    net = port(jnet)
    a = t(tensor).requires_grad_(True)
    img = port_march(engine, net, t(rs), t(rd), a, mode, differentiable=True,
                     enable_early_out=False)
    (img * torch.tensor(w)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    grads["tf"] = a.grad.numpy()
    # every knot and Gaussian gets a gradient
    assert (np.abs(jgrads["tf"]).max(axis=1) > 0).all()
    check((np.asarray(jimg), jgrads), (img.detach().numpy(), grads))


@pytest.mark.parametrize("tf", TFS)
def test_kernel_checks_take_every_count(tf):
    """No count is refused: both engines' checks take the TF in the
    render (the Gaussians on the SnakeAlt network, whose instances render
    them) and in training; up to TF_STAGED_POINTS points the plans count
    the TF, above none of it (the plan of no TF)."""
    tensor, mode = tf_of(tf)
    net = port(jnet_of(channels=8))
    table, points, _ = fused_dvr.prepare_tf(t(tensor), mode)
    floats = sample_mlp.tf_floats_of(mode, table)
    rays = torch.zeros(256, 8)
    for diff in (False, True):
        fused_mega._check_kernel_inputs(net, rays, 256, differentiable=diff,
                                        tf_floats=floats, tf_mode=mode)
        fused_dvr._check_kernel_inputs(net, table, differentiable=diff,
                                       tf_mode=mode)
    staged = sample_mlp.staged_tf_floats(mode, floats)
    above = points > sample_mlp.TF_STAGED_POINTS
    assert staged == (0 if above else floats)
    args = (32, 6, 1, 2, points)
    assert (sample_mlp.fwd_plan(*args, tf_floats=staged)
            == sample_mlp.fwd_plan(*args, tf_floats=0)) == above
