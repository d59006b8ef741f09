"""Port parity, every TF mode on every network in training (TPU kernel rows
2-3 and 5-6 on networks other than SnakeAlt without direction input): the
port's plain differentiable versions (``mega_trace_dvr_plain`` and
``fused_trace_dvr_plain`` with ``differentiable=True``), the CUDA
kernels' oracles, against the JAX package, at the sizes of
tests/test_torch_tf_modes_grad.py (16x16 rays, stepsize 1/32, 8-point
segments, 64-ray tiles):

- a ReLU network with direction input (the 32-wide shape of
  tests/test_torch_tf_networks.py) under the texture, 1D- and
  2D-preintegrated and Gaussian TFs, on both engines, against the JAX
  custom VJPs in Pallas interpret mode: image atol 1e-4, every gradient
  leaf atol 2e-5 / rtol 1e-3 (the f32 contract of tests/test_fused.py;
  preint1d's atol raised to its float32 noise, see the test);
- a Sine:30 network under the texture TF against autograd through the
  JAX package's float32 lattice march (``trace_dvr(lattice=True)``, no
  early-out): the JAX megakernel's polynomial sine reads 2.9e-3 off that
  oracle. At most ``SINE_SHARE`` of the rays lie beyond 1e-4 and none
  beyond ``SINE_MAX``, as tests/test_torch_tf_networks.py holds the
  render; its gradients are ill-conditioned in float32 whatever computes
  them (one ulp of seeded weight noise moves the oracle's own leaves by
  0.5-1.7% here, the latent grid's most), so each leaf is held to
  ``SINE_FLIP`` times the larger of the two sides' own change under that
  noise (tests/test_torch_mega_networks.py takes the plain version's);
- what the kernels take in training (``_check_kernel_inputs`` of both
  engines): the matrix the JAX package's ``fused_screen_supported``
  routes fused (every activation, with and without direction input, the
  five TF modes, widths 32, 48 and 64), less the limits the port keeps
  (normals, iso, segments other than 32 on the megakernel, tiles other
  than 256 rays on these networks, a Gaussian with an occupancy mask or
  in the render).

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_kernels.py (``anytf and training``) and chip_smoke.py
phase Y."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace_dvr
from fvsrn_tpu.train.screen import \
    fused_screen_supported as jfused_screen_supported
from fvsrn_tpu.transfer import TransferFunctionGaussian as JGauss
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu.transfer import TransferFunctionTexture as JTex
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.ops import fused_dvr, fused_mega
from fvsrn_tpu_torch.ops.fused_mega import mega_trace_dvr_plain
from fvsrn_tpu_torch.ops.sample_mlp import tf_floats_of
from fvsrn_tpu_torch.scenes import dense_tf_modes
from fvsrn_tpu_torch.train.screen import fused_screen_supported
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from tests.test_torch_segment import (BMIN, BSIZE, RAMP, jnet_of, port,
                                      rays16, t)
from tests.test_torch_tf_modes import GAUSSIANS, H, MODES, SEG, STEPS, TILE
from tests.test_torch_tf_modes_grad import both, check
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
# the sigmoid ``density`` head keeps the random network's densities inside
# (0, 1), where the TF's gradient reaches the network (``density:direct``
# clips most of them)
RELU_DIR = dict(activation="ReLU", direction=True, output_mode="density")
SINE = dict(activation="Sine:30", output_mode="density")
SINE_SHARE = 0.02   # of the rays beyond 1e-4 of the lattice oracle
SINE_MAX = 1e-3
ULP_NOISE = 1e-7    # relative weight noise: one float32 ulp
SINE_FLIP = 5.0     # a leaf's bound, in units of its change under it
PREINT_FLIP = 5.0   # preint1d's atol, in the same units


def _noisy(jnet, seed=5):
    """``jnet`` with every float32 leaf moved by a seeded relative
    ULP_NOISE (one ulp)."""
    noise = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(jnet)
    return jax.tree_util.tree_unflatten(tree, [
        (np.asarray(v) * (1.0 + ULP_NOISE * noise.standard_normal(
            np.shape(v)))).astype(np.float32)
        if np.asarray(v).dtype == np.float32 else v for v in leaves])


@pytest.mark.parametrize("engine", ["segment", "mega"])
@pytest.mark.parametrize("mode", MODES)
def test_grad_matches_jax(mode, engine):
    """Each TF mode's adjoint on the ReLU network with direction input
    (the direction's Fourier block among the leaves); preint2d reads
    nearest cells: only its table has a gradient. preint1d's far branch
    divides by d - prev (> 1e-3): on this network's slowly varying
    densities one ulp of weight noise moves JAX's own network leaves by
    up to 7.6e-5, over the contract's 2e-5, and the two packages' leaves
    differ by 2-3 times that. There each leaf's atol is the contract's or
    PREINT_FLIP times the larger of the two sides' own largest change
    under that noise, whichever is larger (rtol 1e-3 kept)."""
    jnet = jnet_of(channels=8, **RELU_DIR)
    want, got = both(engine, mode, jnet)
    if mode != "preint1d":
        zero = ()
        if mode == "preint2d":
            zero = tuple(n for n in want[1] if n != "pre")
        check(want, got, zero)
        return
    (jimg, jgrads), (img, grads) = want, got
    (_, jmoved), (_, moved) = both(engine, mode, _noisy(jnet))
    assert jimg[:, 3].max() > 0.1
    np.testing.assert_allclose(img, jimg, atol=1e-4)
    assert sorted(grads) == sorted(jgrads)
    for name in jgrads:
        assert np.abs(jgrads[name]).max() > 0, name
        own = max(np.abs(jmoved[name] - jgrads[name]).max(),
                  np.abs(moved[name] - grads[name]).max())
        np.testing.assert_allclose(grads[name], jgrads[name],
                                   atol=max(2e-5, PREINT_FLIP * own),
                                   rtol=1e-3, err_msg=name)


def _texture():
    """The ramp as 64 texels: (numpy tensor, JAX TF)."""
    tex = np.asarray(dense_tf_modes(H, texels=64)["texture"].tensor)
    return tex, JTex(tensor=jnp.asarray(tex))


def _port_sine(arrays, meta, rs, rd, w, tex):
    """(image, grads) of sum(w * rgba) through the plain differentiable
    megakernel march, no early-out; the TF's gradient as "tf"."""
    net = srn_from_arrays(arrays, meta)
    a = t(tex).requires_grad_(True)
    img = mega_trace_dvr_plain(t(rs), t(rd), net, BMIN, BSIZE, a,
                               stepsize=H, seg=SEG, tile=TILE,
                               tf_mode="texture", differentiable=True,
                               enable_early_out=False)
    (img * t(w)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    grads["tf"] = a.grad.numpy()
    return img.detach().numpy(), grads


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_sine(jnet, rs, rd, w, tex):
    """(image, grads) of sum(w * rgba) through autograd of the JAX
    package's float32 lattice march, no early-out."""
    def jloss(net, tensor):
        img = jtrace_dvr(jnp.asarray(rs), jnp.asarray(rd), JVolume.make(net),
                         JTex(tensor=tensor),
                         JCfg.make(stepsize=H, enable_early_out=False),
                         STEPS, lattice=True).color
        return jnp.sum(img * w), img

    (_, img), (gnet, gtf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnet, jnp.asarray(tex))
    grads, _ = network_arrays(gnet)
    grads["tf"] = np.asarray(gtf)
    return np.asarray(img), grads


def test_sine30_grad_matches_lattice_oracle():
    """Sine:30 under the texture TF: the plain pair against autograd
    through the JAX float32 lattice march (see the module doc)."""
    jnet = jnet_of(channels=8, **SINE)
    rs, rd = rays16()
    tex, _ = _texture()
    w = np.random.default_rng(11).uniform(-1, 1, (rs.shape[0], 4)).astype(
        np.float32)
    jimg, jgrads = _jax_sine(jnet, rs, rd, w, tex)
    arrays, meta = network_arrays(jnet)
    img, grads = _port_sine(arrays, meta, rs, rd, w, tex)
    assert jimg[:, 3].max() > 0.3
    err = np.abs(img - jimg).max(axis=1)
    assert float((err > 1e-4).mean()) <= SINE_SHARE
    assert float(err.max()) <= SINE_MAX
    assert sorted(grads) == sorted(jgrads)
    # both sides under the same seeded one-ulp noise in every weight
    noisy = _noisy(jnet, seed=3)
    _, jmoved = _jax_sine(noisy, rs, rd, w, tex)
    _, moved = _port_sine(*network_arrays(noisy), rs, rd, w, tex)
    for leaf in jgrads:
        assert np.abs(jgrads[leaf]).max() > 0, leaf
        own = max(_rel(moved[leaf], grads[leaf]),
                  _rel(jmoved[leaf], jgrads[leaf]))
        assert own > 1e-3, leaf      # ill-conditioned: see the module doc
        assert _rel(grads[leaf], jgrads[leaf]) <= SINE_FLIP * own, leaf


ACTIVATIONS = ("ReLU", "Sine:30", "Sigmoid", "Softplus", "Snake:1",
               "SnakeAlt:2")
WIDTHS = (32, 48, 64, 96, 128)


def _tfs():
    """{mode: (port TF object, JAX TF object, prepare_tf table)} of the
    five TF modes: the ramp, its texture, its preintegrations and four
    Gaussians."""
    modes = dense_tf_modes(H, texels=64, preint_1d=64, preint_2d=16)
    ramp = TransferFunctionPiecewiseLinear.make(**RAMP)
    out = {"piecewise": (ramp, JTF.make(**RAMP))}
    _, jtex = _texture()
    for mode in ("texture", "preint1d", "preint2d"):
        out[mode] = (modes[mode], jtex)
    out["gaussian"] = (modes["gaussian"],
                       JGauss(tensor=jnp.asarray(GAUSSIANS, jnp.float32)))
    tables = {}
    for mode, (tfo, _) in out.items():
        tensor, kw = fused_dvr.fused_tf_args(tfo)
        tables[mode] = fused_dvr.prepare_tf(tensor, mode, kw.get("tf_pre"))[0]
    return {m: (p, j, tables[m]) for m, (p, j) in out.items()}


@pytest.mark.parametrize("width", WIDTHS)
def test_kernels_take_what_jax_trains_fused(width):
    """Every activation, with and without direction input, and every TF
    mode at this width: the JAX package routes screen training fused,
    so does the port, and both engines' kernels take it in training."""
    rays = torch.zeros(512, 8)
    tfs = _tfs()
    for act in ACTIVATIONS:
        for direction in (False, True):
            jnet = JSRN.make(layers=f"{width}:{width}:{width}",
                             activation=act, num_fourier=6,
                             output_mode="density", seed=7,
                             use_direction=direction,
                             disable_direction_in_fourier=not direction)
            net = port(jnet)
            for mode, (tfo, jtf, table) in tfs.items():
                assert jfused_screen_supported(jnet, jtf, 512, 512)
                assert fused_screen_supported(net, tfo, 512, 512)
                fused_mega._check_kernel_inputs(
                    net, rays, 256, 32, differentiable=True,
                    tf_floats=(5 * table.shape[0] if mode == "piecewise"
                               else tf_floats_of(mode, table)),
                    tf_mode=mode)
                fused_dvr._check_kernel_inputs(net, table, 32,
                                               differentiable=True,
                                               tf_mode=mode)


def test_kernels_keep_their_training_limits():
    """What the kernels still refuse on these networks: normals with a TF
    mode and in training, an iso march in training, backward segments
    other than 32 (the megakernel) or above 32 (the per-segment engine),
    tiles other than 256 rays, and a Gaussian with an occupancy mask or in
    the render."""
    net = port(jnet_of(channels=8, **RELU_DIR))
    rays = torch.zeros(512, 8)
    tfs = _tfs()
    tex, gauss = tfs["texture"][2], tfs["gaussian"][2]
    mega = dict(tf_floats=tex.numel(), tf_mode="texture", differentiable=True)
    with pytest.raises(NotImplementedError, match="normals"):
        fused_mega._check_kernel_inputs(net, rays, 256, need_normals=True,
                                        **mega)
    with pytest.raises(NotImplementedError, match="normals"):
        fused_dvr._check_kernel_inputs(net, tex, tf_mode="texture",
                                       need_normals=True)
    with pytest.raises(NotImplementedError, match="normals"):
        fused_dvr._check_normals_request(net, differentiable=True,
                                         need_normals=True, iso_value=None)
    with pytest.raises(ValueError, match="iso"):
        fused_dvr._check_normals_request(net, differentiable=True,
                                         need_normals=False, iso_value=0.5)
    with pytest.raises(NotImplementedError, match="seg"):
        fused_mega._check_kernel_inputs(net, rays, 256, 16, **mega)
    with pytest.raises(NotImplementedError, match="seg"):
        fused_dvr._check_kernel_inputs(net, tex, 64, differentiable=True,
                                       tf_mode="texture")
    with pytest.raises(NotImplementedError, match="tiles of 256"):
        fused_mega._check_kernel_inputs(net, rays, 128, **mega)
    g = dict(tf_floats=gauss.numel(), tf_mode="gaussian")
    with pytest.raises(NotImplementedError, match="occupancy mask"):
        fused_mega._check_kernel_inputs(net, rays, 256, differentiable=True,
                                        masked=True, **g)
    with pytest.raises(NotImplementedError, match="gaussian"):
        fused_mega._check_kernel_inputs(net, rays, 256, **g)
    with pytest.raises(NotImplementedError, match="gaussian"):
        fused_dvr._check_kernel_inputs(net, gauss, tf_mode="gaussian")


def test_library_routing():
    """The training forward's library on these networks: the generic
    TF-mode instances, the Gaussians' apart."""
    relu = port(jnet_of(channels=8, **RELU_DIR))
    for mode, mega, seg in (("texture", "mega_fwd_anytf",
                             "segment_fwd_anytf"),
                            ("gaussian", "mega_fwd_anyg",
                             "segment_fwd_anyg")):
        spec = fused_mega._spec(relu, BMIN, BSIZE, stepsize=H, seg=32,
                                tile=256, density_min=0.0, density_max=1.0,
                                enable_early_out=True, tf_mode=mode)
        assert fused_mega._fwd_kind(spec, fused_mega._net_args(spec)) == mega
        sspec = SimpleNamespace(tf_mode=mode, activation=("ReLU", 1.0))
        assert fused_dvr.segment_library(sspec) == seg
    assert fused_mega.library_name("mega_fwd_anyg", 64) == "mega_fwd_anyg64"
