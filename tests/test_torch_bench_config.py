"""Port parity, bench.py's training configuration (``bench.py:133-176``):
128-ray megakernel tiles, 32-point segments, a bf16 latent table under
training and per-bucket occupancy masks, the port's plain versions
against the JAX package in Pallas interpret mode on the same numpy
inputs (16x16 views in bench.py's 16x8 pixel blocks, h = 1/32, 8^3 grids;
each JAX result computed once, in a module fixture):

- ``mega_trace_dvr_plain(tile=128, seg=32, table_dtype=bf16,
  differentiable=True)`` with the early-out on, against JAX's
  ``mega_trace_dvr``: image atol 1e-4; every weight, the Fourier matrix
  and the TF atol 2e-5 / rtol 1e-3; the latent grid per element within
  2^-7 of JAX's value (relative) plus the float32 contract's 2e-5. Both
  sum a table cell's gradient in float32 and round it to bf16 once, in
  another order: one bf16 ulp where a sum rounds the other way, and one
  more at the border cells, whose halo copies JAX rounds apart before
  it folds them in (``fvsrn_tpu/ops/fused_mega.py:118-130, 999-1001``);
  2^-7 is at least two ulps. The 2e-5 is the float32 contract's
  absolute floor, for cells whose sum cancels;
- the same at tile 256: the vote is per tile, so the tile is part of the
  result (the two images differ where it fires);
- the per-segment engine's pair (rows 5-6) with a bf16 table, against
  JAX's ``fused_trace_dvr(differentiable=True, table_dtype=bf16)``, the
  weights as above; the grid per element within 2^-7 of JAX's value plus
  2^-8 of the leaf's largest, and in norm within 2^-8. The port rounds
  each cell's float32 sum once; JAX rounds every segment's cotangent of
  its table (the neighborhood table holds a cell in up to eight corner
  slots, each rounded apart) and adds the segments' in bf16
  (``fvsrn_tpu/ops/fused_dvr_bwd.py:1339-1340``), up to eight roundings
  a segment, of partial sums that need not shrink where the cell's sum
  cancels: hence a floor tied to the leaf's scale. This is a named
  deviation from JAX (README, "Known deviations"; ROADMAP section B);
  the test prints the gap;
- ``fused_trace_dvr_bucketed(engine="mega", segment_active_groups=...)``
  on the sparse flagship at 32x32, against JAX's, with the masks of the
  port's own ``plan_segment_occupancy`` (equal to JAX's), and the scan
  engine's refusal of masks;
- ``mega_supported`` with a bf16 table, against JAX's.

The CUDA instances (tile 128, the bf16 table in rows 3 and 6) are held
against these plain versions on the card by tests/test_torch_kernels.py
and chip_smoke.py's phase R (this file imports JAX, which the card's
machine does not have)."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.ops import occupancy as jocc
from fvsrn_tpu.ops.fused_dvr import block_ray_permutation as jperm
from fvsrn_tpu.ops.fused_dvr import fused_trace_dvr as jfused
from fvsrn_tpu.ops.fused_dvr import fused_trace_dvr_bucketed as jbucketed
from fvsrn_tpu.ops.fused_dvr import plan_ray_buckets as jplan
from fvsrn_tpu.ops.fused_dvr import probe_saturation_tmax as jprobe
from fvsrn_tpu.ops.fused_mega import mega_supported as jmega_supported
from fvsrn_tpu.ops.fused_mega import mega_trace_dvr as jmega
from fvsrn_tpu.raytracer.dvr import max_steps_bound
from fvsrn_tpu.scenes import sparse_scene as jsparse_scene
from fvsrn_tpu.train.checkpoints import RunCheckpoint
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.ops import occupancy
from fvsrn_tpu_torch.ops.fused_dvr import (fused_trace_dvr,
                                           fused_trace_dvr_bucketed,
                                           fused_trace_dvr_plain,
                                           mega_supported, plan_ray_buckets)
from fvsrn_tpu_torch.ops.fused_mega import (mega_trace_dvr,
                                            mega_trace_dvr_plain)
from fvsrn_tpu_torch.scenes import sparse_scene
from fvsrn_tpu_torch.train.checkpoints import load_weights
from tools.export_torch_weights import network_arrays

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_mega_grad import (BMIN, BSIZE, POSITIONS,  # noqa: E402
                                  RGB, jax_net)

torch.set_num_threads(1)
H = 1 / 32
SEG = 32
STEPS = max_steps_bound(BSIZE, H)
OPACITY = [6.0, 12.0, 24.0]
EARLY = 0.95            # the vote's threshold: it fires in tile 0 at 128
GRID_REL = 2.0 ** -7    # two bf16 ulps (see the module doc)
GRID_ATOL = 2e-5
SEG_GRID_FLOOR = 2.0 ** -8   # rows 5-6: of the leaf's largest element


def bench_rays(width=16, distance=1.3):
    """Rays of a width^2 view in bench.py's 16x8 pixel blocks."""
    rs, rd = jgenerate_rays(JCam.make(pitch=0.3, yaw=0.5, distance=distance),
                            width, width)
    perm, _ = jperm(width, width, 16, 8)
    return (np.asarray(rs).reshape(-1, 3)[perm],
            np.asarray(rd).reshape(-1, 3)[perm])


def vote_clip(n):
    """A clip that kills one ray of tile 1: its alpha stays 0, so tile 1
    never saturates, and a 256-ray tile holding it never votes stop."""
    clip = np.full(n, 10.0, np.float32)
    clip[200] = 0.0
    return clip


def weights_of(n):
    return np.random.default_rng(11).uniform(-1, 1, (n, 4)).astype(
        np.float32)


def mega_both(tile):
    """(JAX (image, grads), port (image, grads, samples)) of loss =
    sum(w * rgba) at ``tile``, bf16 table, differentiable, early-out on."""
    rs, rd = bench_rays()
    clip = vote_clip(rs.shape[0])
    w = weights_of(rs.shape[0])
    jnet = jax_net()
    jtf = JTF.make(rgb=RGB, opacity=OPACITY, positions=POSITIONS)

    def jloss(net, tf_tensor):
        img = jmega(jnp.asarray(rs), jnp.asarray(rd), net, BMIN, BSIZE,
                    tf_tensor, stepsize=H, max_steps=STEPS, seg=SEG,
                    tile=tile, enable_early_out=True, alpha_early_out=EARLY,
                    differentiable=True, table_dtype=jnp.bfloat16,
                    tmax_clip=jnp.asarray(clip), interpret=True)
        return jnp.sum(img * w), img

    (_, jimg), (gnet, gtf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnet, jnp.asarray(jtf.tensor))
    jgrads, _ = network_arrays(gnet)
    jgrads["tf"] = np.asarray(gtf)
    net = srn_from_arrays(*network_arrays(jnet))
    tf = torch.tensor(np.asarray(jtf.tensor), requires_grad=True)
    img, samples = mega_trace_dvr_plain(
        torch.tensor(rs), torch.tensor(rd), net, BMIN, BSIZE, tf,
        stepsize=H, seg=SEG, tile=tile, alpha_early_out=EARLY,
        tmax_clip=torch.tensor(clip), differentiable=True,
        table_dtype=torch.bfloat16, return_samples=True)
    (img * torch.tensor(w)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    grads["tf"] = tf.grad.numpy()
    return (np.asarray(jimg), jgrads), (img.detach().numpy(), grads,
                                        samples.numpy())


@pytest.fixture(scope="module")
def mega128():
    return mega_both(128)


@pytest.fixture(scope="module")
def mega256():
    return mega_both(256)


def check_grads(grads, jgrads, segment_engine=False):
    assert sorted(grads) == sorted(jgrads)
    for name in jgrads:
        assert np.abs(jgrads[name]).max() > 0, name
        if name == "latent.static_grid":
            want = jgrads[name]
            err = np.abs(grads[name] - want)
            bound = GRID_REL * np.abs(want) + (
                SEG_GRID_FLOOR * np.abs(want).max() if segment_engine
                else GRID_ATOL)
            assert (err <= bound).all(), (name, float((err - bound).max()))
            if segment_engine:
                assert (np.linalg.norm(grads[name] - want)
                        <= SEG_GRID_FLOOR * np.linalg.norm(want))
        else:
            np.testing.assert_allclose(grads[name], jgrads[name], atol=2e-5,
                                       rtol=1e-3, err_msg=name)


def test_mega_bf16_training_tile128_matches_jax(mega128):
    """bench.py's march: tile 128, seg 32, bf16 table, differentiable,
    early-out on; the grid's gradient is bf16 (rounded once per cell)."""
    (jimg, jgrads), (img, grads, _) = mega128
    np.testing.assert_allclose(img, jimg, atol=1e-4)
    check_grads(grads, jgrads)
    g = torch.from_numpy(grads["latent.static_grid"])
    assert torch.equal(g, g.to(torch.bfloat16).float())


def test_mega_tile256_matches_jax_and_the_tile_decides(mega128, mega256):
    """At tile 256 the port holds JAX too, and the two tiles' images
    differ where the vote fires: tile 0 of the 128-ray march votes stop,
    the 256-ray tile (which holds the dead ray) does not."""
    (jimg256, jgrads256), (img256, grads256, samples256) = mega256
    (jimg128, _), (img128, _, samples128) = mega128
    np.testing.assert_allclose(img256, jimg256, atol=1e-4)
    check_grads(grads256, jgrads256)
    assert samples128.shape == (2,) and samples256.shape == (1,)
    assert samples128.sum() < samples256.sum()
    diff = np.abs(img128 - img256).max(axis=1)
    assert diff[:128].max() > 1e-3          # tile 0 stopped early at 128
    assert diff[128:].max() == 0.0          # tile 1 ran to its end in both
    assert np.abs(jimg128 - jimg256).max() > 1e-3


def test_mega_kernel_wrapper_runs_plain_on_cpu(mega128):
    """``mega_trace_dvr`` on CPU tensors at bench.py's configuration is
    its plain version, bit for bit."""
    rs, rd = bench_rays()
    clip = torch.tensor(vote_clip(rs.shape[0]))
    jtf = JTF.make(rgb=RGB, opacity=OPACITY, positions=POSITIONS)
    kw = dict(stepsize=H, seg=SEG, tile=128, alpha_early_out=EARLY,
              tmax_clip=clip, differentiable=True,
              table_dtype=torch.bfloat16)
    outs = []
    for fn in (mega_trace_dvr, mega_trace_dvr_plain):
        net = srn_from_arrays(*network_arrays(jax_net()))
        img = fn(torch.tensor(rs), torch.tensor(rd), net, BMIN, BSIZE,
                 torch.tensor(np.asarray(jtf.tensor)), **kw)
        (img ** 2).mean().backward()
        outs.append((img.detach(), net.latent.static_grid.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(outs[0][0].numpy(), mega128[1][0], atol=0)


# ---------------------------------------------------------------------------
# rows 5-6 with a bf16 table


def segment_both(latent_mode):
    """(JAX (image, grads), port (image, grads)) of the per-segment
    engine's differentiable march with a bf16 table."""
    rs, rd = bench_rays()
    w = weights_of(rs.shape[0])
    jnet = jax_net()
    jtf = JTF.make(rgb=RGB, opacity=OPACITY, positions=POSITIONS)
    kw = dict(stepsize=H, max_steps=STEPS, seg=SEG, tile=128,
              differentiable=True, latent_mode=latent_mode)

    def jloss(net, tf_tensor):
        img = jfused(rs, rd, net, BMIN, BSIZE, tf_tensor, interpret=True,
                     table_dtype=jnp.bfloat16, **kw)
        return jnp.sum(img * w), img

    (_, jimg), (gnet, gtf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnet, jnp.asarray(jtf.tensor))
    jgrads, _ = network_arrays(gnet)
    jgrads["tf"] = np.asarray(gtf)
    net = srn_from_arrays(*network_arrays(jnet))
    tf = torch.tensor(np.asarray(jtf.tensor), requires_grad=True)
    img = fused_trace_dvr(torch.tensor(rs), torch.tensor(rd), net, BMIN,
                          BSIZE, tf, table_dtype=torch.bfloat16, **kw)
    (img * torch.tensor(w)).sum().backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    grads["tf"] = tf.grad.numpy()
    return (np.asarray(jimg), jgrads), (img.detach().numpy(), grads)


@pytest.mark.parametrize("latent_mode", ["table", "boxfeat"])
def test_segment_grad_bf16_table_matches_jax(latent_mode):
    """Rows 5-6 train on a bf16 table (refused before): the grid's
    gradient rounded to bf16 once per cell, the rest as JAX's."""
    (jimg, jgrads), (img, grads) = segment_both(latent_mode)
    assert jimg[:, 3].max() > 0.1
    np.testing.assert_allclose(img, jimg, atol=1e-4)
    got, want = grads["latent.static_grid"], jgrads["latent.static_grid"]
    d = np.abs(got - want)
    print(f"rows 5-6 bf16 grid vs JAX ({latent_mode}): max|d| "
          f"{d.max() / np.abs(want).max():.3g} of the leaf's largest, norm "
          f"{np.linalg.norm(got - want) / np.linalg.norm(want):.3g} "
          f"relative, {int((d > GRID_REL * np.abs(want) + GRID_ATOL).sum())}"
          f" of {d.size} elements beyond {GRID_REL:.3g} of their value + "
          f"{GRID_ATOL}")
    check_grads(grads, jgrads, segment_engine=True)
    g = torch.from_numpy(grads["latent.static_grid"])
    assert torch.equal(g, g.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# per-bucket occupancy masks on the sparse flagship


@pytest.fixture(scope="module")
def sparse_case():
    """The sparse flagship, bench.py's setup at 32x32: the saturation
    clip (JAX's probe, coarse 8, margin 16), a 3-bucket plan of 128-ray
    tiles in each package, and the occupancy grid (resolution 16, fine 2,
    alpha_skip 1e-5)."""
    _, jtf, ckpt = jsparse_scene()
    with RunCheckpoint(ckpt, "r") as ck:
        jnet = ck.load_weights()
    _, tf, npz = sparse_scene()
    rs, rd = bench_rays(32, distance=1.6)
    clip = np.asarray(jprobe(rs, rd, JVolume.make(jnet), jtf, stepsize=H,
                             max_steps=STEPS, coarse=8, margin_steps=16),
                      np.float32)
    kw = dict(stepsize=H, seg=SEG, tile=128, n_buckets=3,
              grid_sizes=(32, 32, 32), tmax_clip=clip)
    jp = jplan(rs, rd, BMIN, BSIZE, **kw)
    p = plan_ray_buckets(rs, rd, BMIN, BSIZE, **kw)
    occ = jocc.build_occupancy(JVolume.make(jnet), jtf, resolution=16,
                               fine=2, stepsize=H, alpha_skip=1e-5)
    return dict(jnet=jnet, jtf=jtf, net=load_weights(npz), tf=tf, rs=rs,
                rd=rd, jplan=jp, plan=p, occ=occ)


def test_bucketed_mega_masks_match_jax(sparse_case):
    """bench.py's sparse arm: per-bucket masks from the port's
    plan_segment_occupancy (equal to JAX's) culled in each bucket's
    megakernel; the image against JAX's within 2e-4 (the sparse TF's
    zero-band edge, 60 per unit density, amplifies the float32 order of
    JAX's factorized trilerp: the port reads 1.13e-4 off JAX here with a
    float32 table and no mask too, in 2 of 4096 channels), and the masks
    culled samples (the culled image equals the unculled one within
    1e-4)."""
    c = sparse_case
    np.testing.assert_array_equal(c["plan"].perm, c["jplan"].perm)
    masks = occupancy.plan_segment_occupancy(
        c["plan"], c["rs"], c["rd"], c["occ"], BMIN, BSIZE, stepsize=H,
        seg=SEG, tile=128)
    jmasks = jocc.plan_segment_occupancy(
        c["jplan"], c["rs"], c["rd"], c["occ"], BMIN, BSIZE, stepsize=H,
        seg=SEG, tile=128)
    assert len(masks) == len(c["plan"].group_sizes) == 3
    for m, jm in zip(masks, jmasks):
        np.testing.assert_array_equal(m, jm)
    assert not all(m.all() for m in masks)
    want = np.asarray(jbucketed(
        jnp.asarray(c["rs"]), jnp.asarray(c["rd"]), c["jnet"], BMIN, BSIZE,
        jnp.asarray(c["jtf"].tensor), plan=c["jplan"], stepsize=H, seg=SEG,
        tile=128, enable_early_out=True, differentiable=False,
        latent_mode="boxfeat", table_dtype=jnp.bfloat16, engine="mega",
        segment_active_groups=tuple(jnp.asarray(m) for m in jmasks),
        interpret=True))
    kw = dict(plan=c["plan"], engine="mega", stepsize=H, seg=SEG, tile=128,
              table_dtype=torch.bfloat16, return_stats=True)
    rs, rd = torch.tensor(c["rs"]), torch.tensor(c["rd"])
    tft = c["tf"].tensor
    got, st = fused_trace_dvr_bucketed(
        rs, rd, c["net"], BMIN, BSIZE, tft,
        segment_active_groups=tuple(torch.from_numpy(m) for m in masks),
        **kw)
    full, st_full = fused_trace_dvr_bucketed(rs, rd, c["net"], BMIN, BSIZE,
                                             tft, **kw)
    assert want[:, 3].max() > 0.5
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    assert int(st.samples) < int(st_full.samples)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-4)


def test_bucketed_mask_gradients_pass_the_permutation(sparse_case):
    """The masked bucketed route trains (bf16 table): the network's
    gradient of the culled march equals the unculled one's (zero-band
    samples have no network gradient, bench.py:42-46), 2e-5 / 1e-3."""
    c = sparse_case
    masks = occupancy.plan_segment_occupancy(
        c["plan"], c["rs"], c["rd"], c["occ"], BMIN, BSIZE, stepsize=H,
        seg=SEG, tile=128)
    grads = []
    for m in (tuple(torch.from_numpy(x) for x in masks), None):
        net = load_weights(sparse_scene()[2])
        img = fused_trace_dvr_bucketed(
            torch.tensor(c["rs"]), torch.tensor(c["rd"]), net, BMIN, BSIZE,
            c["tf"].tensor, plan=c["plan"], engine="mega", stepsize=H,
            seg=SEG, tile=128, table_dtype=torch.bfloat16,
            differentiable=True, segment_active_groups=m)
        (img ** 2).mean().backward()
        grads.append({n: p.grad for n, p in net.named_parameters()})
    for name in grads[0]:
        assert grads[1][name].abs().max() > 0, name
        torch.testing.assert_close(grads[0][name], grads[1][name],
                                   atol=2e-5, rtol=1e-3)


def test_scan_engine_refuses_masks(sparse_case):
    """Masks are the megakernel's, in both packages."""
    c = sparse_case
    masks = tuple(np.ones((1, 1), bool) for _ in c["plan"].group_sizes)
    with pytest.raises(NotImplementedError):
        jbucketed(jnp.asarray(c["rs"]), jnp.asarray(c["rd"]), c["jnet"],
                  BMIN, BSIZE, jnp.asarray(c["jtf"].tensor),
                  plan=c["jplan"], stepsize=H, seg=SEG, tile=128,
                  engine="scan", segment_active_groups=masks,
                  interpret=True)
    with pytest.raises(NotImplementedError):
        fused_trace_dvr_bucketed(
            torch.tensor(c["rs"]), torch.tensor(c["rd"]), c["net"], BMIN,
            BSIZE, c["tf"].tensor, plan=c["plan"], engine="scan",
            stepsize=H, seg=SEG, tile=128, march=fused_trace_dvr_plain,
            segment_active_groups=tuple(torch.from_numpy(m)
                                        for m in masks))


@pytest.mark.parametrize("shape", [(16, 32, 32, 32), (16, 48, 32, 32),
                                   (16, 64, 64, 64), (8, 40, 40, 40),
                                   (20, 8, 8, 8), None])
def test_mega_supported_bf16_matches_jax(shape):
    """The route rule with a bf16 table (half the float32 slab); a
    16 x 48 x 32^3 grid fits the budget in bf16 only."""
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        assert mega_supported(shape, dtype) == jmega_supported(shape, jdtype)
    assert (mega_supported((16, 48, 32, 32), torch.bfloat16)
            and not mega_supported((16, 48, 32, 32), torch.float32))
