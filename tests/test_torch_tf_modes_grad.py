"""Port parity, the TF modes of the fused marches' differentiable pairs
(the texture, 1D- and 2D-preintegrated and Gaussian adjoints of TPU kernel
rows 2-3 and 5-6): the port's plain differentiable versions
(``fused_trace_dvr_plain`` and ``mega_trace_dvr_plain`` with
``differentiable=True``) against the JAX package's custom VJPs
(``fused_trace_dvr`` and ``mega_trace_dvr``, Pallas interpret mode) on the
same numpy-seeded network, rays, TF tables and cotangent: image atol 1e-4,
every gradient leaf (each weight and bias, the Fourier matrix, the latent
grid, the TF tensor and its preintegration table) atol 2e-5 / rtol 1e-3,
the f32 contract of tests/test_fused.py. The 1D preintegration's
previous-density chain crosses segment boundaries (8-sample segments over
rays of up to 56 samples), and is held under an occupancy mask against the
JAX package's masked megakernel, and on a network whose neighbouring
samples mostly take the near branch. The CUDA kernels are held against
these plain versions on the card by tests/test_torch_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.ops.fused_dvr import fused_trace_dvr as jfused
from fvsrn_tpu.ops.fused_mega import mega_trace_dvr as jmega
from fvsrn_tpu_torch.ops.fused_dvr import fused_trace_dvr_plain
from fvsrn_tpu_torch.ops.fused_mega import mega_trace_dvr_plain
from tests.test_torch_segment import BMIN, BSIZE, jnet_of, port, rays16, t
from tests.test_torch_tf_modes import (ENGINES, H, MODES, SEG, STEPS, TILE,
                                       jax_tf, slow_net)
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)


def both(engine, mode, jnet, mask=None):
    """(JAX (image, grads), port (image, grads)) of loss = sum(w * rgba);
    grads keyed by leaf name, the TF as "tf", its table as "pre"."""
    rs, rd = rays16()
    tensor, pre = jax_tf(mode)
    w = np.random.default_rng(11).uniform(-1, 1, (rs.shape[0], 4)).astype(
        np.float32)
    kw = dict(stepsize=H, seg=SEG, tile=TILE, tf_mode=mode,
              differentiable=True)
    lat = dict(latent_mode="boxfeat") if engine == "lattice" else {}
    sa = {} if mask is None else dict(segment_active=jnp.asarray(mask))

    def jloss(net, a, b):
        if engine == "mega":
            img = jmega(rs, rd, net, BMIN, BSIZE, a, tf_pre=b,
                        max_steps=STEPS, table_dtype=jnp.float32,
                        interpret=True, **kw, **sa)
        else:
            img = jfused(rs, rd, net, BMIN, BSIZE, a, tf_pre=b,
                         max_steps=STEPS, interpret=True, **kw, **lat)
        return jnp.sum(img * w), img

    pre_j = None if pre is None else jnp.asarray(pre)
    (_, jimg), (gnet, ga, gb) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jnet, jnp.asarray(tensor),
                                                pre_j)
    jgrads, _ = network_arrays(gnet)
    jgrads["tf"] = np.asarray(ga)
    if pre is not None:
        jgrads["pre"] = np.asarray(gb)

    net = port(jnet)
    a = t(tensor).requires_grad_(True)
    b = None if pre is None else t(pre).requires_grad_(True)
    args = (t(rs), t(rd), net, BMIN, BSIZE, a)
    if engine == "mega":
        msk = {} if mask is None else dict(segment_active=torch.tensor(mask))
        img = mega_trace_dvr_plain(*args, tf_pre=b, **kw, **msk)
    else:
        img = fused_trace_dvr_plain(*args, tf_pre=b, max_steps=STEPS, **kw,
                                    **lat)
    (img * torch.tensor(w)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    grads["tf"] = (a.grad.numpy() if a.grad is not None
                   else np.zeros(a.shape, np.float32))
    if b is not None:
        grads["pre"] = b.grad.numpy()
    return (np.asarray(jimg), jgrads), (img.detach().numpy(), grads)


def check(want, got, zero=()):
    (jimg, jgrads), (img, grads) = want, got
    assert jimg[:, 3].max() > 0.1
    np.testing.assert_allclose(img, jimg, atol=1e-4)
    assert sorted(grads) == sorted(jgrads)
    for name in jgrads:
        if name in zero:
            assert np.abs(jgrads[name]).max() == 0, name
        else:
            assert np.abs(jgrads[name]).max() > 0, name
        np.testing.assert_allclose(grads[name], jgrads[name], atol=2e-5,
                                   rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
def test_grad_matches_jax(mode, engine):
    """Each TF mode's adjoint through each engine. preint2d reads nearest
    cells: only its table has a gradient (the network's and the unused
    plain table's are zero on both sides)."""
    jnet = jnet_of(channels=8)
    want, got = both(engine, mode, jnet)
    zero = ()
    if mode == "preint2d":
        zero = tuple(n for n in want[1] if n != "pre")
    check(want, got, zero)


def test_masked_preint1d_matches_jax():
    """A seeded mask culls a third of the megakernel's (tile, segment)
    programs: a culled segment leaves the previous density alone and
    passes its cotangent through, as the JAX package's masked megakernel
    does; forward and every gradient."""
    n_seg = -(-STEPS // SEG) + 2
    mask = np.random.default_rng(4).random((4, n_seg)) > 0.33
    want, got = both("mega", "preint1d", jnet_of(channels=8), mask)
    check(want, got)


@pytest.mark.parametrize("engine", ["segment", "mega"])
def test_near_branch_grad_matches_jax(engine):
    """The near branch's plain-table adjoint beside the preintegrated
    one's (tests/test_torch_tf_modes.py::slow_net: most, not all,
    neighbouring samples take it)."""
    check(*both(engine, "preint1d", slow_net()))
