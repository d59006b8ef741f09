"""Port parity, the per-segment engine's differentiable march (TPU kernel
rows 5-6, ``make_segment_op``): the port's plain differentiable version
(``fused_trace_dvr_plain(differentiable=True)``) against the JAX
``fused_trace_dvr(differentiable=True)`` in Pallas interpret mode, on the
same numpy-seeded rays and weights: loss rtol 1e-5, image atol 1e-4, and
every gradient leaf (each layer's weight and bias, the Fourier matrix,
the latent grid, the TF with its knot positions) atol 2e-5 / rtol 1e-3,
the contract of tests/test_fused.py; both sides gate the knot positions
strictly, so they hold the same tolerance. One exception: the JAX kernel
evaluates sine by a polynomial (``_fast_sin``), and Sine:3 layers carry
its error into the first layer's gradient, beyond that tolerance of the
JAX package's own float32 oracle (autodiff through
``raytracer.dvr.trace_dvr``, the oracle of tests/test_fused.py); there
the network's gradients are held against that oracle, at the same
tolerance, and the TF's against the kernel. The CUDA kernels are held
against this plain version on the card by tests/test_torch_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolumeNetwork
from fvsrn_tpu.ops.fused_dvr import fused_trace_dvr as jfused
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import max_steps_bound
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace_dvr
from fvsrn_tpu_torch.ops import fused_dvr_bwd
from fvsrn_tpu_torch.ops.fused_dvr import (fused_trace_dvr,
                                           fused_trace_dvr_plain)
from tests.test_torch_segment import (BMIN, BSIZE, RAMP, flat, jnet_of, port,
                                      rays16, t, tfs)
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
H = 1 / 32
SEG, TILE = 8, 64
STEPS = max_steps_bound(BSIZE, H)

CASES = {
    "nogrid": dict(net=dict(channels=0)),
    "grid8_table": dict(net=dict(channels=8)),
    "grid20_features": dict(net=dict(channels=20)),
    "rgbo": dict(net=dict(output_mode="rgbo")),
    "rgbo_direct": dict(net=dict(output_mode="rgbo:direct")),
    "relu": dict(net=dict(activation="ReLU")),
    "sine": dict(net=dict(activation="Sine:3"), oracle=True),
    # the sigmoid head: a density:direct head clips every sample here
    "direction": dict(net=dict(direction=True, output_mode="density")),
    "alpha_blend": dict(net={}, kw=dict(blend_mode="alpha")),
    "lattice": dict(net={}, kw=dict(latent_mode="boxfeat")),
    # saturating rays with the early-out asked for: the differentiable
    # march has none (the round-1 trap, tests/test_fused.py:165-200)
    "saturating_early_out": dict(net={}, tf=flat(8.0), kw=dict(
        enable_early_out=True, alpha_early_out=0.9)),
}


def both(case):
    """(JAX (loss, image, grads), port (loss, image, grads)) of loss =
    sum(w * rgba), w random; grads keyed by leaf name, the TF as "tf"."""
    spec = CASES[case]
    jnet = jnet_of(**spec["net"])
    jtf, tf = tfs(spec.get("tf", RAMP))
    rs, rd = rays16()
    kw = dict(stepsize=H, max_steps=STEPS, seg=SEG, tile=TILE,
              differentiable=True, **spec.get("kw", {}))
    w = np.random.default_rng(11).uniform(-1, 1, (rs.shape[0], 4)).astype(
        np.float32)

    def jloss(net, tf_tensor):
        if not spec.get("oracle"):
            img = jfused(rs, rd, net, BMIN, BSIZE, tf_tensor,
                         interpret=True, **kw)
        else:
            # the fused image; the network's gradient from the oracle, the
            # TF's from the kernel (at ties the oracle's clip gives the
            # knot positions another subgradient)
            img = jfused(rs, rd, jax.lax.stop_gradient(net), BMIN, BSIZE,
                         tf_tensor, interpret=True, **kw)
            ref = jtrace_dvr(
                jnp.asarray(rs), jnp.asarray(rd), JVolumeNetwork.make(net),
                type(jtf)(tensor=jax.lax.stop_gradient(tf_tensor)),
                JCfg.make(stepsize=H, enable_early_out=False), STEPS).color
            img = img + ref - jax.lax.stop_gradient(ref)
        return jnp.sum(img * w), img

    (jl, jimg), (gnet, gtf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnet, jnp.asarray(jtf.tensor))
    jgrads, _ = network_arrays(gnet)
    jgrads["tf"] = np.asarray(gtf)

    net = port(jnet)
    tf_leaf = tf.tensor.clone().requires_grad_(True)
    img = fused_trace_dvr_plain(t(rs), t(rd), net, BMIN, BSIZE, tf_leaf, **kw)
    loss = (img * torch.tensor(w)).sum()
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    grads["tf"] = (tf_leaf.grad.numpy() if tf_leaf.grad is not None
                   else np.zeros(tf_leaf.shape, np.float32))
    return ((float(jl), np.asarray(jimg), jgrads),
            (float(loss.detach()), img.detach().numpy(), grads))


@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_grad_matches_jax(case):
    (jl, jimg, jgrads), (loss, img, grads) = both(case)
    assert jimg[:, 3].max() > 0.1
    np.testing.assert_allclose(img, jimg, atol=1e-4)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    rgbo = CASES[case]["net"].get("output_mode", "density").startswith("rgbo")
    for name in jgrads:
        if not (rgbo and name == "tf"):      # rgbo heads read no TF
            assert np.abs(jgrads[name]).max() > 0, name
        np.testing.assert_allclose(grads[name], jgrads[name], atol=2e-5,
                                   rtol=1e-3, err_msg=name)
    if case == "saturating_early_out":
        # rays saturate, and the render's early-out would have changed the
        # image: the differentiable march is the one without it
        assert jimg[:, 3].max() > 0.999
        jnet = jnet_of()
        tf = tfs(flat(8.0))[1].tensor
        rs, rd = rays16()
        kw = dict(stepsize=H, max_steps=STEPS, seg=SEG, tile=TILE)
        no_out = fused_trace_dvr_plain(t(rs), t(rd), port(jnet), BMIN, BSIZE,
                                       tf, enable_early_out=False, **kw)
        early = fused_trace_dvr_plain(t(rs), t(rd), port(jnet), BMIN, BSIZE,
                                      tf, alpha_early_out=0.9, **kw)
        np.testing.assert_allclose(img, no_out.numpy(), atol=1e-6)
        assert np.abs(img - early.numpy()).max() > 1e-3


def test_segment_grad_wrapper_runs_plain_on_cpu():
    """CPU tensors: the wrapper runs the plain pair (no launch), with the
    same image and gradients; the rays get no gradient."""
    jnet = jnet_of()
    rs, rd = rays16()
    kw = dict(stepsize=H, max_steps=STEPS, seg=SEG, tile=TILE,
              differentiable=True)
    tf = tfs(RAMP)[1].tensor
    out = {}
    before = (fused_dvr_bwd.launches("segment_fwd_diff"),
              fused_dvr_bwd.launches("segment_bwd"))
    for fn in (fused_trace_dvr, fused_trace_dvr_plain):
        net = port(jnet)
        rs_leaf = t(rs).requires_grad_(True)
        img = fn(rs_leaf, t(rd), net, BMIN, BSIZE, tf, **kw)
        img.sum().backward()
        assert rs_leaf.grad is None or not rs_leaf.grad.any()
        out[fn] = (img.detach(), {n: p.grad for n, p in
                                  net.named_parameters()})
    assert (fused_dvr_bwd.launches("segment_fwd_diff"),
            fused_dvr_bwd.launches("segment_bwd")) == before
    (a, ga), (b, gb) = out.values()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for name in ga:
        torch.testing.assert_close(ga[name], gb[name], rtol=0, atol=0)


@pytest.mark.parametrize("kw,error", [
    (dict(table_dtype=torch.float16), ValueError),
    # ported; piecewise knots are no texture table
    (dict(tf_mode="texture"), ValueError),
    (dict(need_normals=True), NotImplementedError),
    (dict(iso_value=0.5), ValueError),
    (dict(subbox="auto"), TypeError)])
def test_segment_grad_rejects_what_is_not_ported(kw, error):
    """What the slice leaves out raises (a float16 table is no table
    type of the engine: bf16 trains since the bench configuration's
    slice, ``test_segment_grad_bf16_table``); the TPU's memory schedules
    (``segment_remat``, ``stash_backward``) are accepted and change
    nothing."""
    rs, rd = rays16()
    net = port(jnet_of())
    tf = tfs(RAMP)[1].tensor
    base = dict(stepsize=H, max_steps=STEPS, seg=SEG, tile=TILE,
                differentiable=True)
    with pytest.raises(error):
        fused_trace_dvr(t(rs), t(rd), net, BMIN, BSIZE, tf, **base, **kw)
    plain = fused_trace_dvr(t(rs), t(rd), net, BMIN, BSIZE, tf, **base)
    remat = fused_trace_dvr(t(rs), t(rd), net, BMIN, BSIZE, tf, **base,
                            segment_remat=True, stash_backward=True)
    torch.testing.assert_close(plain, remat, rtol=0, atol=0)
