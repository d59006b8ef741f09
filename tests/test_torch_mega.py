"""Port parity, fused march: the plain version of the port's megakernel
(``mega_trace_dvr_plain``) against the JAX megakernel run in Pallas
interpret mode with its bf16 latent table, atol 1e-4 (the fused-vs-oracle
contract of tests/test_fused.py), and the planning helpers it relies on.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.ops.fused_dvr import block_ray_permutation as jblock_perm
from fvsrn_tpu.ops.fused_dvr import probe_saturation_tmax as jprobe
from fvsrn_tpu.ops.fused_mega import mega_trace_dvr as jmega
from fvsrn_tpu.raytracer.dvr import max_steps_bound
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.ops import fused_mega
from fvsrn_tpu_torch.ops.fused_dvr import (block_ray_permutation,
                                           probe_saturation_tmax)
from fvsrn_tpu_torch.ops.fused_mega import (mega_trace_dvr,
                                            mega_trace_dvr_plain)
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
ATOL = 1e-4
H = 1 / 64
SEG, TILE = 16, 64
BMIN, BSIZE = (-0.5, -0.5, -0.5), (1.0, 1.0, 1.0)
RGB = [[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9]]
POSITIONS = [0.0, 0.45, 1.0]


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(7)
    lat = JLatent(static_grid=(rng.standard_normal((8, 8, 8, 8)) * 0.3)
                  .astype(np.float32))
    jnet = JSRN.make(layers="32:32:32", activation="SnakeAlt:2",
                     num_fourier=6, output_mode="density:direct",
                     latent=lat, seed=7)
    return jnet, srn_from_arrays(*network_arrays(jnet))


def block_rays(distance, width=16):
    """Rays of a width^2 view in 8x8 pixel blocks (tiles of 64 rays)."""
    rs, rd = jgenerate_rays(JCam.make(pitch=0.3, yaw=0.8, distance=distance),
                            width, width)
    perm, _ = jblock_perm(width, width, 8, 8)
    return (np.asarray(rs).reshape(-1, 3)[perm],
            np.asarray(rd).reshape(-1, 3)[perm])


def tfs(opacity):
    return (JTF.make(rgb=RGB, opacity=opacity, positions=POSITIONS),
            TransferFunctionPiecewiseLinear.make(RGB, opacity, POSITIONS))


def both(nets, rs, rd, opacity, clip=None, early_out=True):
    """(JAX image, port image, port samples per tile)."""
    jnet, net = nets
    jtf, tf = tfs(opacity)
    want = np.asarray(jmega(
        jnp.asarray(rs), jnp.asarray(rd), jnet, BMIN, BSIZE, jtf.tensor,
        stepsize=H, max_steps=max_steps_bound(BSIZE, H), seg=SEG, tile=TILE,
        enable_early_out=early_out, table_dtype=jnp.bfloat16,
        tmax_clip=None if clip is None else jnp.asarray(clip),
        interpret=True))
    got, samples = mega_trace_dvr_plain(
        t(rs), t(rd), net, BMIN, BSIZE, tf.tensor, stepsize=H,
        tmax_clip=None if clip is None else t(clip), seg=SEG, tile=TILE,
        enable_early_out=early_out, return_samples=True)
    return want, got.numpy(), samples.numpy()


@pytest.mark.parametrize("w,h,bw,bh", [(32, 32, 16, 16), (48, 16, 8, 8),
                                       (16, 32, 16, 8)])
def test_block_ray_permutation(w, h, bw, bh):
    jperm, jinv = jblock_perm(w, h, bw, bh)
    perm, inv = block_ray_permutation(w, h, bw, bh, device="cpu")
    np.testing.assert_array_equal(perm.numpy(), jperm)
    np.testing.assert_array_equal(inv.numpy(), jinv)
    with pytest.raises(ValueError):
        block_ray_permutation(w + 1, h, bw, bh, device="cpu")


def test_probe_saturation_tmax(nets):
    jnet, net = nets
    rs, rd = block_rays(1.6)
    jtf, tf = tfs([20.0, 60.0, 120.0])
    steps = max_steps_bound(BSIZE, H)
    want = jprobe(rs, rd, JVolume.make(jnet), jtf, stepsize=H,
                  max_steps=steps, coarse=8, margin_steps=16)
    got = probe_saturation_tmax(t(rs), t(rd), VolumeInterpolationNetwork(net),
                                tf, stepsize=H, max_steps=steps, coarse=8,
                                margin_steps=16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    tmax = np.min(np.maximum((-0.5 - rs) / rd, (0.5 - rs) / rd), axis=1)
    assert (want < tmax - 1e-3).mean() > 0.2  # the clip bites


def test_mega_plain_matches_jax_clipped(nets):
    """Product-like march: saturation clip from the probe, early-out."""
    jnet, net = nets
    rs, rd = block_rays(1.6)
    jtf, _ = tfs([2.0, 10.0, 30.0])
    clip = jprobe(rs, rd, JVolume.make(jnet), jtf, stepsize=H,
                  max_steps=max_steps_bound(BSIZE, H), coarse=8,
                  margin_steps=16)
    want, got, _ = both(nets, rs, rd, [2.0, 10.0, 30.0], clip=clip)
    assert want[:, 3].max() > 0.5
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_mega_plain_matches_jax_vote_fires(nets):
    """Every ray hits and saturates: the tile vote stops the march."""
    rs, rd = block_rays(1.1)
    opacity = [60.0, 200.0, 400.0]
    want, got, samples = both(nets, rs, rd, opacity)
    _, tf = tfs(opacity)
    _, full = mega_trace_dvr_plain(
        t(rs), t(rd), nets[1], BMIN, BSIZE, tf.tensor, stepsize=H, seg=SEG,
        tile=TILE, enable_early_out=False, return_samples=True)
    assert (samples < full.numpy()).all()   # the vote fired in every tile
    assert want[:, 3].min() > 0.999
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_mega_plain_matches_jax_box_missing_rays(nets):
    """Tiles mixing rays that miss the box with rays that hit it: the
    missing rays take part in k0t and in the vote."""
    rs, rd = block_rays(2.6)
    t0 = np.minimum((-0.5 - rs) / rd, (0.5 - rs) / rd).max(axis=1)
    t1 = np.maximum((-0.5 - rs) / rd, (0.5 - rs) / rd).min(axis=1)
    hit = (t1 > t0).reshape(-1, TILE)
    assert (hit.any(axis=1) & ~hit.all(axis=1)).all()
    want, got, _ = both(nets, rs, rd, [20.0, 60.0, 120.0])
    assert want[:, 3].max() > 0.5
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got[~hit.reshape(-1)], 0.0)


def test_mega_wrapper_runs_plain_on_cpu(nets):
    rs, rd = block_rays(1.6)
    _, tf = tfs([2.0, 10.0, 30.0])
    kw = dict(stepsize=H, seg=SEG, tile=TILE)
    before = fused_mega.launches("mega_fwd")
    got = mega_trace_dvr(t(rs), t(rd), nets[1], BMIN, BSIZE, tf.tensor, **kw)
    want = mega_trace_dvr_plain(t(rs), t(rd), nets[1], BMIN, BSIZE,
                                tf.tensor, **kw)
    assert fused_mega.launches("mega_fwd") == before
    torch.testing.assert_close(got, want, rtol=0, atol=0)
