"""Port parity, the texture and preintegrated TFs on every network (TPU
kernel rows 1 and 4's forward on networks other than SnakeAlt without
direction input): the port's plain megakernel march
(``mega_trace_dvr_plain``) and plain per-segment march
(``fused_trace_dvr_plain``, per-ray sampling and the lattice), the CUDA
kernels' oracles, against the JAX package, at the sizes of
tests/test_torch_tf_modes.py (16x16 rays, stepsize 1/32, 8-point
segments, 64-ray tiles):

- a ReLU network with direction input and a Softplus network (a smooth
  activation) against the JAX megakernel and segment kernel in Pallas
  interpret mode, atol 1e-4;
- a Sine:30 network (the sigmoid ``density`` head, as
  tests/test_torch_mega_networks.py takes it) against the JAX package's
  float32 lattice march (``trace_dvr(lattice=True)``, no early-out),
  whose latent trilerp and Fourier features round in another order: the
  30x pre-activations carry that float32 noise to ~1.2e-4 in a few rays,
  so at most ``SINE_SHARE`` of the rays may lie beyond 1e-4, and none
  beyond ``SINE_MAX`` (preint2d: ``FLIP_MAX``, its nearest cell flips on
  that noise, as tests/test_torch_kernels.py holds it). The JAX kernels
  read further off the same oracle (their polynomial sine: 1.6e-3 to
  4.3e-2 here), which the test asserts, so that it shows why;
- what the kernels take: these networks in the render's forward on both
  kernels (``_check_kernel_inputs``), and in training
  (tests/test_torch_tf_train_networks.py holds the training pairs).

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_kernels.py (``anytf``) and chip_smoke.py phase X."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace_dvr
from fvsrn_tpu_torch.ops import fused_dvr, fused_mega
from fvsrn_tpu_torch.scenes import dense_tf_modes
from tests.test_torch_segment import BMIN, BSIZE, jnet_of, port, rays16
from tests.test_torch_tf_modes import (H, STEPS, jax_image, port_image,
                                       texture)

torch.set_num_threads(1)
ATOL = 1e-4
MODES = ("texture", "preint1d", "preint2d")
ENGINES = ("segment", "lattice", "mega")
NETS = {"relu_dir": dict(activation="ReLU", direction=True),
        "softplus": dict(activation="Softplus")}
SINE = dict(activation="Sine:30", output_mode="density")
SINE_SHARE = 0.02   # of the rays beyond ATOL of the lattice oracle
SINE_MAX = 1e-3     # texture, preint1d
FLIP_MAX = 5e-2     # preint2d


def jax_tf_object(mode):
    tex = texture()
    if mode == "texture":
        return tex
    if mode == "preint1d":
        return tex.with_preintegration(64)
    return tex.with_preintegration_2d(16, stepsize=H)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(NETS))
def test_march_matches_jax_kernels(name, mode, engine):
    jnet = jnet_of(channels=8, **NETS[name])
    rs, rd = rays16()
    want = jax_image(engine, mode, jnet, rs, rd)
    got = port_image(engine, mode, port(jnet), rs, rd)
    assert want[:, 3].max() > 0.3
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("engine", ["lattice", "mega"])
@pytest.mark.parametrize("mode", MODES)
def test_sine30_matches_lattice_oracle(mode, engine):
    jnet = jnet_of(channels=8, **SINE)
    rs, rd = rays16()
    want = np.asarray(jtrace_dvr(
        jnp.asarray(rs), jnp.asarray(rd), JVolume.make(jnet),
        jax_tf_object(mode), JCfg.make(stepsize=H, enable_early_out=False),
        STEPS, lattice=True).color)
    got = port_image(engine, mode, port(jnet), rs, rd,
                     enable_early_out=False)
    assert want[:, 3].max() > 0.3
    err = np.abs(got - want).max(axis=1)
    assert float((err > ATOL).mean()) <= SINE_SHARE
    assert float(err.max()) <= (FLIP_MAX if mode == "preint2d" else SINE_MAX)
    kernel = jax_image(engine, mode, jnet, rs, rd, enable_early_out=False)
    assert float(np.abs(kernel - want).max()) > err.max()


@pytest.mark.parametrize("name", sorted(NETS) + ["sine30"])
def test_kernels_take_these_networks_in_the_render(name):
    kw = NETS.get(name, SINE)
    net = port(jnet_of(channels=8, **kw))
    rays = torch.zeros(512, 8)
    tfs = dense_tf_modes(H, texels=64, preint_1d=64, preint_2d=16)
    for mode in MODES:
        tensor, tf_kw = fused_dvr.fused_tf_args(tfs[mode])
        tf, _, _ = fused_dvr.prepare_tf(tensor, mode, tf_kw.get("tf_pre"))
        for diff in (False, True):
            fused_mega._check_kernel_inputs(net, rays, 256, tf_floats=1024,
                                            tf_mode=mode, differentiable=diff)
            fused_dvr._check_kernel_inputs(net, tf, tf_mode=mode,
                                           differentiable=diff)
        with pytest.raises(NotImplementedError, match="tiles of 256"):
            fused_mega._check_kernel_inputs(net, rays, 128, tf_floats=1024,
                                            tf_mode=mode)
    gauss = torch.rand(4, 6)
    with pytest.raises(NotImplementedError, match="gaussian"):
        fused_mega._check_kernel_inputs(net, rays, 256, tf_floats=48,
                                        tf_mode="gaussian")
    with pytest.raises(NotImplementedError, match="gaussian"):
        fused_dvr._check_kernel_inputs(net, gauss, tf_mode="gaussian")


def test_library_routing():
    """The forward's library: the generic TF-mode instances for these
    networks, the SnakeAlt ones otherwise."""
    relu = port(jnet_of(channels=8, **NETS["relu_dir"]))
    snake = port(jnet_of(channels=8))
    snake_dir = port(jnet_of(channels=8, direction=True))
    for net, mega, seg in ((relu, "mega_fwd_anytf", "segment_fwd_anytf"),
                           (snake_dir, "mega_fwd_anytf", "segment_fwd_tf"),
                           (snake, "mega_fwd_tf", "segment_fwd_tf")):
        spec = fused_mega._spec(net, BMIN, BSIZE, stepsize=H, seg=32,
                                tile=256, density_min=0.0, density_max=1.0,
                                enable_early_out=True, tf_mode="texture")
        assert fused_mega._fwd_kind(spec, fused_mega._net_args(spec)) == mega
        sspec = SimpleNamespace(tf_mode="texture",
                                activation=(net.layers[0].activation, 2.0))
        assert fused_dvr.segment_library(sspec) == seg
    assert fused_mega.library_name("mega_fwd_anytf", 48) == "mega_fwd_anytf48"
