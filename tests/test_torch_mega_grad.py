"""Port parity, differentiable fused march: the plain differentiable version
of the port's megakernel (``mega_trace_dvr_plain(differentiable=True)``)
against the JAX megakernel's custom VJP (``mega_trace_dvr(
differentiable=True, table_dtype=float32)`` in Pallas interpret mode),
on the same rays and weights: loss rtol 1e-5, image atol 1e-4, and every
gradient leaf (Fourier matrix, each weight and bias, the latent grid, the
TF) atol 2e-5 / rtol 1e-3, the contract of tests/test_fused.py. The CUDA
kernels are held against this plain version on the card by
tests/test_torch_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.ops.fused_dvr import block_ray_permutation as jblock_perm
from fvsrn_tpu.ops.fused_mega import mega_trace_dvr as jmega
from fvsrn_tpu.raytracer.dvr import max_steps_bound
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.ops import fused_mega
from fvsrn_tpu_torch.ops.fused_mega import mega_trace_dvr_plain
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
H = 1 / 64
SEG, TILE = 16, 64
BMIN, BSIZE = (-0.5, -0.5, -0.5), (1.0, 1.0, 1.0)
RGB = [[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9]]
POSITIONS = [0.0, 0.45, 1.0]


def jax_net(out_shift=0.0, grid=True):
    rng = np.random.default_rng(7)
    lat = JLatent(static_grid=(rng.standard_normal((8, 8, 8, 8)) * 0.3)
                  .astype(np.float32) if grid else None)
    jnet = JSRN.make(layers="32:32:32", activation="SnakeAlt:2",
                     num_fourier=6, output_mode="density:direct",
                     latent=lat, seed=7)
    if out_shift:
        last = jnet.layers[-1]
        last = last.replace(bias=np.asarray(last.bias + out_shift,
                                            np.float32))
        jnet = jnet.replace(layers=jnet.layers[:-1] + (last,))
    return jnet


def block_rays(distance, width=16, yaw=0.8):
    """Rays of a width^2 view in 8x8 pixel blocks (tiles of 64 rays)."""
    rs, rd = jgenerate_rays(JCam.make(pitch=0.3, yaw=yaw, distance=distance),
                            width, width)
    perm, _ = jblock_perm(width, width, 8, 8)
    return (np.asarray(rs).reshape(-1, 3)[perm],
            np.asarray(rd).reshape(-1, 3)[perm])


def both(jnet, rs, rd, opacity, clip=None, early_out=True):
    """(JAX (loss, image, grads), port (loss, image, grads, samples)) of
    loss = sum(w * rgba); grads keyed by leaf name, the TF as "tf"."""
    w = np.random.default_rng(11).uniform(-1, 1, (rs.shape[0], 4)).astype(
        np.float32)
    jtf = JTF.make(rgb=RGB, opacity=opacity, positions=POSITIONS)

    def jloss(net, tf_tensor):
        img = jmega(jnp.asarray(rs), jnp.asarray(rd), net, BMIN, BSIZE,
                    tf_tensor, stepsize=H, max_steps=max_steps_bound(BSIZE, H),
                    seg=SEG, tile=TILE, enable_early_out=early_out,
                    differentiable=True, table_dtype=jnp.float32,
                    tmax_clip=None if clip is None else jnp.asarray(clip),
                    interpret=True)
        return jnp.sum(img * w), img

    (jl, jimg), (gnet, gtf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnet, jnp.asarray(jtf.tensor))
    jgrads, _ = network_arrays(gnet)
    jgrads["tf"] = np.asarray(gtf)

    net = srn_from_arrays(*network_arrays(jnet))
    tf = torch.tensor(np.asarray(jtf.tensor), requires_grad=True)
    img, samples = mega_trace_dvr_plain(
        torch.tensor(rs), torch.tensor(rd), net, BMIN, BSIZE, tf,
        stepsize=H, seg=SEG, tile=TILE, enable_early_out=early_out,
        tmax_clip=None if clip is None else torch.tensor(clip),
        differentiable=True, return_samples=True)
    loss = (img * torch.tensor(w)).sum()
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    grads["tf"] = tf.grad.numpy()
    return ((float(jl), np.asarray(jimg), jgrads),
            (float(loss.detach()), img.detach().numpy(), grads,
             samples.numpy()))


def check(want, got):
    (jl, jimg, jgrads), (l, img, grads, _) = want, got
    np.testing.assert_allclose(img, jimg, atol=1e-4)
    np.testing.assert_allclose(l, jl, rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    for name in jgrads:
        assert np.abs(jgrads[name]).max() > 0, name
        np.testing.assert_allclose(grads[name], jgrads[name], atol=2e-5,
                                   rtol=1e-3, err_msg=name)


def test_mega_grad_clip_and_vote():
    """Saturating TF and a per-ray clip: the tile vote fires, and the
    backward replays it."""
    rs, rd = block_rays(1.1)
    opacity = [60.0, 200.0, 400.0]
    tmax = np.min(np.maximum((-0.5 - rs) / rd, (0.5 - rs) / rd), axis=1)
    clip = (tmax - np.random.default_rng(3).uniform(0.0, 0.3, tmax.shape)
            ).astype(np.float32)
    want, got = both(jax_net(), rs, rd, opacity, clip=clip)
    _, _, _, samples = got
    net = srn_from_arrays(*network_arrays(jax_net()))
    tf = torch.tensor(np.asarray(JTF.make(rgb=RGB, opacity=opacity,
                                          positions=POSITIONS).tensor))
    _, full = mega_trace_dvr_plain(
        torch.tensor(rs), torch.tensor(rd), net, BMIN, BSIZE, tf,
        stepsize=H, seg=SEG, tile=TILE, tmax_clip=torch.tensor(clip),
        enable_early_out=False, table_dtype=torch.float32,
        return_samples=True)
    assert (samples < full.numpy()).all()   # the vote fired in every tile
    check(want, got)


def test_mega_grad_box_missing_rays():
    """Tiles mixing rays that miss the box with rays that hit it."""
    rs, rd = block_rays(2.6)
    t0 = np.minimum((-0.5 - rs) / rd, (0.5 - rs) / rd).max(axis=1)
    t1 = np.maximum((-0.5 - rs) / rd, (0.5 - rs) / rd).min(axis=1)
    hit = (t1 > t0).reshape(-1, TILE)
    assert (hit.any(axis=1) & ~hit.all(axis=1)).all()
    want, got = both(jax_net(), rs, rd, [20.0, 60.0, 120.0])
    check(want, got)


def test_mega_grad_outputs_clipped_at_zero():
    """A share of the samples clip at value 0, exactly at the first knot
    of a TF that absorbs there: the kernel's adjoint gives those samples'
    knot positions no gradient (interior-only), where autograd through
    min/max would split the tie."""
    jnet = jax_net(out_shift=-0.006)
    rs, rd = block_rays(1.6)
    net = srn_from_arrays(*network_arrays(jnet))
    x = torch.rand(4096, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        clipped = float((net(x)[:, 0] == 0).float().mean())
    assert 0.1 < clipped < 0.9
    want, got = both(jnet, rs, rd, [2.0, 10.0, 30.0])
    check(want, got)
    np.testing.assert_allclose(got[2]["tf"][:, 4], want[2]["tf"][:, 4],
                               atol=2e-5, rtol=1e-3)


def test_mega_grad_without_latent_grid():
    """A network with no latent grid, as the trainer builds by default."""
    rs, rd = block_rays(1.6)
    want, got = both(jax_net(grid=False), rs, rd, [20.0, 60.0, 120.0])
    assert "latent.static_grid" not in got[2]
    check(want, got)


def test_mega_grad_rejects_ray_gradients():
    """Without ``ray_grads`` the rays get no gradient (the JAX op's zero
    cotangent), even where they require one; and a bf16 table trains (it
    was refused before): the grid's gradient is the float32 sum rounded
    to bf16 once per cell, and the other leaves are those of the float32
    table's march on the bf16-rounded grid."""
    rs, rd = block_rays(1.6)
    net = srn_from_arrays(*network_arrays(jax_net()))
    tf = torch.tensor(np.asarray(JTF.make(rgb=RGB, opacity=[2.0, 10.0, 30.0],
                                          positions=POSITIONS).tensor))
    rs_leaf = torch.tensor(rs, requires_grad=True)
    img = mega_trace_dvr_plain(rs_leaf, torch.tensor(rd), net, BMIN, BSIZE,
                               tf, stepsize=H, seg=SEG, tile=TILE,
                               differentiable=True)
    img.sum().backward()
    assert rs_leaf.grad is None
    assert net.layers[0].weight.grad.abs().max() > 0
    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        n = srn_from_arrays(*network_arrays(jax_net()))
        if dtype == torch.float32:
            with torch.no_grad():
                n.latent.static_grid.copy_(n.latent.static_grid.to(
                    torch.bfloat16).float())
        out = mega_trace_dvr_plain(torch.tensor(rs), torch.tensor(rd), n,
                                   BMIN, BSIZE, tf, stepsize=H, seg=SEG,
                                   tile=TILE, differentiable=True,
                                   table_dtype=dtype)
        (out ** 2).mean().backward()
        grads[dtype] = {k: p.grad for k, p in n.named_parameters()}
    g16, g32 = grads[torch.bfloat16], grads[torch.float32]
    grid = g16["latent.static_grid"]
    assert grid.abs().max() > 0
    torch.testing.assert_close(grid, grid.to(torch.bfloat16).float(),
                               rtol=0, atol=0)
    torch.testing.assert_close(grid, g32["latent.static_grid"].to(
        torch.bfloat16).float(), rtol=0, atol=0)
    for k in g16:
        if k != "latent.static_grid":
            torch.testing.assert_close(g16[k], g32[k], rtol=0, atol=0)


def test_mega_grad_wrapper_runs_plain_on_cpu():
    rs, rd = block_rays(1.6)
    net = srn_from_arrays(*network_arrays(jax_net()))
    tf = torch.tensor(np.asarray(JTF.make(rgb=RGB, opacity=[2.0, 10.0, 30.0],
                                          positions=POSITIONS).tensor))
    kw = dict(stepsize=H, seg=SEG, tile=TILE, differentiable=True)
    before = (fused_mega.launches("mega_fwd_diff"),
              fused_mega.launches("mega_bwd"))
    got = fused_mega.mega_trace_dvr(torch.tensor(rs), torch.tensor(rd), net,
                                    BMIN, BSIZE, tf, **kw)
    got.sum().backward()
    want = mega_trace_dvr_plain(torch.tensor(rs), torch.tensor(rd), net,
                                BMIN, BSIZE, tf, **kw)
    assert (fused_mega.launches("mega_fwd_diff"),
            fused_mega.launches("mega_bwd")) == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)
