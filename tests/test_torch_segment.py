"""Port parity, the per-segment engine (TPU kernel row 4): the port's
``fused_trace_dvr`` (its plain version here, on the CPU) against the JAX
``fused_trace_dvr`` in Pallas interpret mode, atol 1e-4 (the
fused-vs-oracle contract of tests/test_fused.py), over the networks and
options the engine serves; the engine's stop rule (global to the call:
saturated rays composite on, padding rays vote); the FUSED routes of
``LoadedModel.prepare_network_render`` against the JAX package's, route
choice included; fault F3 (a grid that fails ``mega_supported`` took the
megakernel); PLAIN16 and FUSED_BF16. The CUDA kernel is held against the
plain version on the card by tests/test_torch_kernels.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.inference import LoadedModel as JLoadedModel
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.ops.fused_dvr import fused_trace_dvr as jfused
from fvsrn_tpu.ops.fused_dvr import plan_ray_buckets as jplan
from fvsrn_tpu.ops.fused_mega import mega_supported as jmega_supported
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch.camera import CameraOnASphere
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.inference import FusedRender, LoadedModel
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.ops import fused_dvr
from fvsrn_tpu_torch.ops.fused_dvr import (fused_trace_dvr,
                                           fused_trace_dvr_plain,
                                           mega_supported, plan_ray_buckets)
from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr, trace_dvr
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from tools.export_torch_weights import _key_name, network_arrays

torch.set_num_threads(1)
ATOL = 1e-4
H = 1 / 64
SEG, TILE = 16, 64
BMIN, BSIZE = (-0.5, -0.5, -0.5), (1.0, 1.0, 1.0)
RAMP = dict(rgb=[[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9]],
            opacity=[2.0, 10.0, 30.0], positions=[0.0, 0.45, 1.0])


def flat(op):
    """A TF absorbing ``op`` at every density: every ray saturates after
    the same number of samples, whatever the network."""
    return dict(rgb=[[1.0, 0.3, 0.1], [0.2, 1.0, 0.4]], opacity=[op, op],
                positions=[0.0, 1.0])


def tfs(spec):
    jtf = JTF.make(**spec)
    return jtf, TransferFunctionPiecewiseLinear(
        torch.tensor(np.asarray(jtf.tensor)))


def jnet_of(channels=8, output_mode="density:direct", activation="SnakeAlt:2",
            direction=False, res=8, seed=7):
    rng = np.random.default_rng(seed)
    lat = JLatent()
    if channels:
        lat = JLatent(static_grid=(rng.standard_normal(
            (channels, res, res, res)) * 0.3).astype(np.float32))
    return JSRN.make(layers="32:32:32", activation=activation,
                     num_fourier=6, output_mode=output_mode, latent=lat,
                     seed=seed, use_direction=direction,
                     disable_direction_in_fourier=not direction)


def port(jnet):
    return srn_from_arrays(*network_arrays(jnet))


def rays16():
    rs, rd = jgenerate_rays(JCam.make(pitch=0.3, yaw=0.8, distance=1.6),
                            16, 16)
    return np.asarray(rs).reshape(-1, 3), np.asarray(rd).reshape(-1, 3)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


CASES = {
    "nogrid": dict(net=dict(channels=0)),
    "grid8_bf16_table": dict(net=dict(channels=8), bf16=True),
    "grid20_f32_features": dict(net=dict(channels=20)),
    "rgbo": dict(net=dict(output_mode="rgbo")),
    "rgbo_direct": dict(net=dict(output_mode="rgbo:direct")),
    "relu": dict(net=dict(activation="ReLU")),
    "sine": dict(net=dict(activation="Sine:3")),
    "direction": dict(net=dict(direction=True)),
    "alpha_blend": dict(net=dict(), kw=dict(blend_mode="alpha")),
    "no_early_out": dict(net=dict(), kw=dict(enable_early_out=False)),
    "lattice": dict(net=dict(), kw=dict(latent_mode="boxfeat")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_trace_dvr_matches_jax(case):
    spec = CASES[case]
    jnet = jnet_of(**spec["net"])
    jtf, tf = tfs(RAMP)
    rs, rd = rays16()
    kw = dict(stepsize=H, max_steps=112, seg=SEG, tile=TILE,
              **spec.get("kw", {}))
    bf16 = spec.get("bf16", False)
    want = np.asarray(jfused(rs, rd, jnet, BMIN, BSIZE, jtf.tensor,
                             table_dtype=jnp.bfloat16 if bf16
                             else jnp.float32, interpret=True, **kw))
    net = port(jnet)
    tdt = torch.bfloat16 if bf16 else torch.float32
    got = fused_trace_dvr_plain(t(rs), t(rd), net, BMIN, BSIZE, tf.tensor,
                                table_dtype=tdt, **kw)
    assert want[:, 3].max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # the wrapper runs the plain version for CPU tensors
    routed = fused_trace_dvr(t(rs), t(rd), net, BMIN, BSIZE, tf.tensor,
                             table_dtype=tdt, **kw)
    np.testing.assert_array_equal(routed.numpy(), got.numpy())


def test_saturated_ray_composites_past_its_death():
    """Trap 1: the stop is the call's, not the ray's. A ray that reached
    alpha 0.999 keeps compositing while another ray lives: the engine
    matches JAX and differs from the per-ray early-out march."""
    jnet = jnet_of()
    jtf, tf = tfs(flat(8.0))
    rs, rd = rays16()
    kw = dict(stepsize=H, max_steps=112, seg=SEG, tile=TILE)
    want = np.asarray(jfused(rs, rd, jnet, BMIN, BSIZE, jtf.tensor,
                             interpret=True, **kw))
    net = port(jnet)
    got, stats = fused_trace_dvr_plain(t(rs), t(rd), net, BMIN, BSIZE,
                                       tf.tensor, return_stats=True, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    per_ray = trace_dvr(t(rs), t(rd), VolumeInterpolationNetwork(net), tf,
                        RayEvaluationSteppingDvr.make(stepsize=H),
                        112).color.detach()
    assert float((got[:, 3] >= 0.999).float().mean()) > 0.2
    assert float((got - per_ray).abs().max()) > 3 * ATOL
    assert 1 < int(stats.stop) < 7


def blob_net(center):
    """A network whose density is the trilerp of a 1-channel 16^3 grid
    that is 1 within 0.15 of ``center`` and 0 elsewhere (ReLU layers pass
    the latent channel through)."""
    c = -0.5 + (np.arange(16) + 0.5) / 16
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    dist = np.sqrt((x - center[0]) ** 2 + (y - center[1]) ** 2
                   + (z - center[2]) ** 2)
    grid = (dist < 0.15).astype(np.float32)[None]
    jnet = JSRN.make(layers="32:32:32", activation="ReLU", num_fourier=6,
                     output_mode="density:direct",
                     latent=JLatent(static_grid=grid), seed=0)
    arrays, _ = network_arrays(jnet)
    new = {}
    for key, a in arrays.items():
        if key.startswith("layers."):
            b = np.zeros_like(a)
            if key == "layers.0.weight":
                b[0, -1] = 1.0               # the latent channel
            elif key.endswith("weight"):
                b[0, 0] = 1.0
            new[key] = b
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(new[_key_name(p)]) if _key_name(p) in new
        else x, jnet)


def test_padding_rays_set_the_stop():
    """Trap 2 on route 2 (24x20: not multiples of 16): rays are padded to
    128-ray tiles with start (0, 0, 0) and direction (1, 1, 1), as in the
    JAX package, and padding rays vote. Here the camera sits inside the
    box, in an opaque blob: every camera ray saturates in its first
    segment, while the padding rays cross empty space up to t = 0.5 and
    set the call's stop. FUSED against JAX FUSED."""
    cam = dict(pitch=0.3, yaw=3.5, distance=0.35)
    rs, _ = jgenerate_rays(JCam.make(**cam), 24, 20)
    jnet = blob_net(np.asarray(rs).reshape(-1, 3)[0])
    jtf, tf = tfs(dict(rgb=[[1.0, 1.0, 1.0], [1.0, 0.5, 0.2]],
                       opacity=[0.0, 400.0], positions=[0.0, 1.0]))
    jm = JLoadedModel(jnet, jtf)
    jm.config = JCfg.make(stepsize=H)
    m = LoadedModel(port(jnet), tf,
                    config=RayEvaluationSteppingDvr.make(stepsize=H))
    want = np.asarray(jm.render_network(JCam.make(**cam), 24, 20, "FUSED",
                                        interpret=True))
    render = m.prepare_network_render(CameraOnASphere.make(**cam), 24, 20,
                                      "FUSED", device="cpu")
    assert render.route == "segment" and render.pad == 32
    np.testing.assert_allclose(render().numpy(), want, atol=ATOL)
    assert want[..., 3].min() > 0.999
    kw = dict(render.march_kwargs, tile=32)
    _, padded = render.march(fused_trace_dvr_plain, return_stats=True)
    _, camera_only = fused_trace_dvr_plain(
        render.ray_start[:480], render.ray_dir[:480], render.network,
        BMIN, BSIZE, tf.tensor, return_stats=True, **kw)
    assert int(camera_only.stop) == 1 and int(padded.stop) == 2


def test_fault_f3_bucketed_route_matches_jax():
    """Fault F3: a grid that fails the JAX megakernel's slab budget (1 x
    48^3, bf16) renders by the bucketed per-segment engine in the JAX
    package, one global stop per bucket. The parent's route, the
    megakernel with its per-tile vote, differs here by 4.1e-4 (a tile
    keeps marching saturated rays, for the sake of rays already past
    their box, after the bucket has stopped); the repaired route matches
    JAX FUSED to 1e-4 at 32x32, h = 1/32."""
    rng = np.random.default_rng(5)
    jnet = JSRN.make(layers="32:32:32", activation="SnakeAlt:2",
                     num_fourier=6, output_mode="density:direct",
                     latent=JLatent(static_grid=(rng.standard_normal(
                         (1, 48, 48, 48)) * 0.5).astype(np.float32)),
                     seed=5)
    assert not jmega_supported((1, 48, 48, 48), jnp.bfloat16)
    jtf, tf = tfs(flat(9.0))
    cam = dict(pitch=0.3, yaw=0.5, distance=1.6)
    jm = JLoadedModel(jnet, jtf)
    jm.config = JCfg.make(stepsize=1 / 32)
    m = LoadedModel(port(jnet), tf,
                    config=RayEvaluationSteppingDvr.make(stepsize=1 / 32))
    want = np.asarray(jm.render_network(JCam.make(**cam), 32, 32, "FUSED",
                                        interpret=True))
    render = m.prepare_network_render(CameraOnASphere.make(**cam), 32, 32,
                                      "FUSED", device="cpu")
    assert render.route == "bucketed"
    np.testing.assert_allclose(render().numpy(), want, atol=ATOL)
    parent = FusedRender(render.ray_start, render.ray_dir, render.inv,
                         render.tmax_clip, render.network, render.tf,
                         m.box_min, m.box_size, 32, 32,
                         dict(stepsize=1 / 32, seg=32, tile=256))
    assert np.abs(parent().numpy() - want).max() > 3 * ATOL


def test_bucketed_mega_engine_matches_one_call():
    """``engine="mega"`` runs the megakernel's wrapper once per bucket:
    its tiles stop on their own votes, so the buckets give the image of
    one call over all tiles (route 1's render)."""
    jnet = jnet_of(channels=8)
    _, tf = tfs(RAMP)
    m = LoadedModel(port(jnet), tf,
                    config=RayEvaluationSteppingDvr.make(stepsize=1 / 32))
    render = m.prepare_network_render(
        CameraOnASphere.make(pitch=0.3, yaw=0.6, distance=1.6), 32, 32,
        "FUSED", device="cpu")
    assert render.route == "mega"
    plan = plan_ray_buckets(render.ray_start.numpy(),
                            render.ray_dir.numpy(), BMIN, BSIZE,
                            stepsize=1 / 32, seg=32, tile=256, n_buckets=3,
                            tmax_clip=render.tmax_clip.numpy())
    assert len(plan.group_sizes) > 1
    got = fused_dvr.fused_trace_dvr_bucketed(
        render.ray_start, render.ray_dir, render.network, BMIN, BSIZE,
        tf.tensor, plan=plan, engine="mega", stepsize=1 / 32, seg=32,
        tile=256)
    np.testing.assert_allclose(got.numpy(), render.march().numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(16, 32, 32, 32), (16, 48, 48, 48),
                                   (1, 48, 48, 48), (1, 40, 40, 40),
                                   (8, 64, 16, 16), (24, 32, 32, 32)])
def test_mega_supported_matches_jax(shape):
    for jdt, dt in ((jnp.bfloat16, torch.bfloat16),
                    (jnp.float32, torch.float32)):
        assert mega_supported(shape, dt) == jmega_supported(shape, jdt)


def jax_route(grid_shape, width, height):
    """The JAX package's route (fvsrn_tpu/inference.py:262-274)."""
    if (grid_shape is not None and grid_shape[0] <= 16
            and width % 16 == 0 and height % 16 == 0):
        return ("mega" if jmega_supported(grid_shape, jnp.bfloat16)
                else "bucketed")
    return "segment"


@pytest.mark.parametrize("grid", [None, (8, 8, 8, 8), (1, 48, 48, 48),
                                  (20, 8, 8, 8)])
def test_route_matches_jax(grid):
    rng = np.random.default_rng(0)
    jnet = JSRN.make(layers="32:32", activation="SnakeAlt:2", num_fourier=4,
                     output_mode="density:direct",
                     latent=JLatent(static_grid=rng.standard_normal(
                         grid).astype(np.float32)) if grid else JLatent())
    _, tf = tfs(RAMP)
    m = LoadedModel(port(jnet), tf,
                    config=RayEvaluationSteppingDvr.make(stepsize=1 / 16))
    cam = CameraOnASphere.make(pitch=0.3, yaw=0.5, distance=1.6)
    for w, h in ((32, 16), (24, 16), (16, 20)):
        route = m.prepare_network_render(cam, w, h, "FUSED",
                                         device="cpu").route
        assert route == jax_route(grid, w, h), (grid, w, h)


def test_plan_ray_buckets_matches_jax():
    """The bucket plan of route 1b with its saturation clip: permutation,
    bucket sizes, step budgets and each bucket's segment count."""
    rs, rd = jgenerate_rays(JCam.make(pitch=0.3, yaw=0.5, distance=1.6),
                            64, 64)
    rs = np.asarray(rs).reshape(-1, 3)
    rd = np.asarray(rd).reshape(-1, 3)
    clip = np.random.default_rng(0).uniform(1.2, 2.4, rs.shape[0]).astype(
        np.float32)
    kw = dict(stepsize=1 / 128, seg=32, tile=256, n_buckets=6,
              grid_sizes=(48, 48, 48), quantize=128, tmax_clip=clip)
    want = jplan(rs, rd, BMIN, BSIZE, **kw)
    got = plan_ray_buckets(rs, rd, BMIN, BSIZE, **kw)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.tmax_clip, want.tmax_clip)
    assert got.group_sizes == want.group_sizes
    assert got.group_steps == want.group_steps
    assert got.group_segments == tuple(s.n_seg for s in want.group_specs)
    assert got.dead == want.dead == 0


@pytest.mark.parametrize("mode", ["FUSED_BF16", "PLAIN16"])
def test_bf16_modes_match_jax(mode):
    """FUSED_BF16 is FUSED for DVR; PLAIN16 rounds every weight through
    bf16 and marches plainly. 16x16, h = 1/32."""
    jnet = jnet_of(channels=8)
    jtf, tf = tfs(RAMP)
    cam = dict(pitch=0.3, yaw=0.6, distance=1.6)
    jm = JLoadedModel(jnet, jtf)
    jm.config = JCfg.make(stepsize=1 / 32)
    m = LoadedModel(port(jnet), tf,
                    config=RayEvaluationSteppingDvr.make(stepsize=1 / 32))
    want = np.asarray(jm.render_network(JCam.make(**cam), 16, 16, mode,
                                        interpret=True))
    got = m.render_network(CameraOnASphere.make(**cam), 16, 16, mode,
                           device="cpu").numpy()
    assert want[..., 3].max() > 0.5
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_engine_rejects_what_is_not_ported():
    net = port(jnet_of())
    _, tf = tfs(RAMP)
    rs, rd = rays16()
    kw = dict(stepsize=H, max_steps=112, seg=SEG, tile=TILE)
    with pytest.raises(NotImplementedError):
        fused_trace_dvr(t(rs), t(rd), net, BMIN, BSIZE, tf.tensor, **kw,
                        differentiable=True, need_normals=True)
    # a bf16 table trains (held to the JAX package by
    # tests/test_torch_bench_config.py): its grid's gradient is bf16
    img = fused_trace_dvr(t(rs), t(rd), net, BMIN, BSIZE, tf.tensor, **kw,
                          differentiable=True, table_dtype=torch.bfloat16)
    img.sum().backward()
    g = net.latent.static_grid.grad
    assert g.abs().max() > 0
    assert torch.equal(g, g.to(torch.bfloat16).float())
    # normals and shading are ported (tests/test_torch_normals.py); they
    # raise where the JAX package raises: normals of an rgbo head or of
    # the iso march, a shading BRDF without normals
    from fvsrn_tpu_torch.brdf import BRDFLambert
    for net_, bad in (
            (port(jnet_of(output_mode="rgbo")), dict(need_normals=True)),
            (net, dict(need_normals=True, iso_value=0.5)),
            (net, dict(brdf=BRDFLambert.make(enable_phong=True)))):
        with pytest.raises(ValueError):
            fused_trace_dvr(t(rs), t(rd), net_, BMIN, BSIZE, tf.tensor,
                            **kw, **bad)
    # the TF modes are ported (tests/test_torch_tf_modes.py); a table that
    # does not fit the mode (piecewise knots as texels) raises
    with pytest.raises(ValueError, match="texture TF tensor"):
        fused_trace_dvr(t(rs), t(rd), net, BMIN, BSIZE, tf.tensor,
                        tf_mode="texture", **kw)
    with pytest.raises(ValueError):
        fused_trace_dvr(t(rs), t(rd), port(jnet_of(output_mode="rgbo")),
                        BMIN, BSIZE, tf.tensor, iso_value=0.5, **kw)
    with pytest.raises(ValueError):
        fused_trace_dvr(t(rs[:100]), t(rd[:100]), net, BMIN, BSIZE,
                        tf.tensor, **kw)
    # the kernels take hidden layers up to 128 wide
    # (tests/test_torch_wide_networks.py); wider ones raise
    wide = port(JSRN.make(layers="160:160", activation="ReLU",
                          num_fourier=4, seed=1))
    with pytest.raises(NotImplementedError):
        fused_dvr.kernel_width(wide)
    assert fused_dvr.kernel_width(port(JSRN.make(
        layers="128:128", activation="ReLU", num_fourier=4, seed=1))) == 128
