"""Port parity, data parallelism (``fvsrn_tpu_torch/parallel``, the
``--data_parallel`` trainer): the JAX package's tests/test_parallel.py
cases run as two ``gloo`` ranks on the CPU (``parallel.mesh.spawn``)
against JAX's ``make_mesh(2)`` on the same numpy inputs: the world and
screen steps (leaves atol 1e-5, loss rtol 1e-5, as JAX's), the latent
grid's all-reduce overlapped with the backward (bitwise equal to the
trailing one), ray-sharded renders of the plain march and of the
per-segment march (its plain version), context-parallel marching (2e-6
of the single-process march, as JAX's) and its early-out refusal, the
ray-sharded Monte-Carlo walk (2e-6 of the single-process walk, as
JAX's), ``train_screen_dp`` for 2 epochs and ``train.main.run
--data_parallel 2``. Every case runs in one spawned job of two ranks
(the module imports no JAX, so that the ranks load none); the JAX side
runs here."""
import os

import numpy as np
import pytest
import torch

from fvsrn_tpu_torch.camera import CameraOnASphere, generate_rays
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.parallel import mesh as pmesh
from fvsrn_tpu_torch.parallel.train_step import (make_cp_render,
                                                 make_dp_render,
                                                 make_dp_screen_train_step,
                                                 make_dp_world_train_step)
from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                           max_steps_bound, trace_dvr)
from fvsrn_tpu_torch.train.losses import LossNetScreen, LossNetWorld
from fvsrn_tpu_torch.train.optimizer import make_optimizer
from fvsrn_tpu_torch.train.screen import ScreenDataset, train_screen_dp
from fvsrn_tpu_torch.train.world import WorldDataset
from fvsrn_tpu_torch.transfer import (TransferFunctionIdentity,
                                      TransferFunctionPiecewiseLinear)
from fvsrn_tpu_torch.volume.implicit import VolumeInterpolationImplicit

torch.set_num_threads(1)
RANKS = 2
TF = dict(rgb=[[1.0, 0.3, 0.1], [0.3, 1.0, 0.5]], opacity=[0.0, 20.0],
          positions=[0.0, 1.0])
CP_TF = dict(rgb=[[1.0, 0.2, 0.1], [0.2, 0.4, 1.0]], opacity=[0.0, 25.0],
             positions=[0.0, 1.0])
SCREEN_LOSS = dict(l1=1.0, l2=0.5, dssim=0.25)
W = 16                       # the screen step's and loop's image size (the
                             # 11-pixel SSIM window needs more than 8)
MC = dict(max_absorption=8.0, max_iterations=64, num_bounces=1)
MAIN_ARGS = ["IMPLICIT:MARSCHNER_LOBB", "OUT", "--mode", "screen",
             "--screen_cameras", "2", "--screen_size", "16", "--stepsize",
             "0.03125", "--layers", "16:16",
             "--volumetric_features_channels", "4",
             "--volumetric_features_resolution", "8",
             "--volumetric_features_std", "0.3", "-i", "2", "-lr", "0.001",
             "--seed", "5", "--data_parallel", "2"]


def _params(net) -> dict:
    return {n: p.detach().cpu().numpy().copy()
            for n, p in net.named_parameters()}


def _np(t):
    return t.detach().cpu().numpy()


def _rays(cam: dict, w: int, h: int):
    rs, rd = generate_rays(CameraOnASphere.make(**cam), w, h, device="cpu")
    return rs.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()


# ---- the ranks' side: port only ------------------------------------------

def _job(mesh, inp: dict) -> dict:
    """Every case on this rank; rank 0's results go back to the test."""
    out = {}
    net_of = lambda: srn_from_arrays(*inp["net"])    # noqa: E731

    # world step: the rank's half of a 128-sample batch
    net = net_of()
    opt = make_optimizer(net.parameters(), "Adam", lr=1e-3)
    step = make_dp_world_train_step(mesh, LossNetWorld(mode="density",
                                                       l1=1.0), opt)
    batch = WorldDataset(*(torch.from_numpy(a) for a in inp["world"]))
    total = step(net, pmesh.shard_batch(mesh, batch))
    out["world"] = (float(total), _params(net))

    # screen step (plain march), the latent all-reduce trailing and
    # overlapped with the backward
    tf = TransferFunctionPiecewiseLinear.make(**TF)
    cfg = RayEvaluationSteppingDvr.make(stepsize=1 / 16,
                                        enable_early_out=False)
    steps = max_steps_bound((1.0, 1.0, 1.0), 1 / 16)
    rs, rd, tgt = (torch.from_numpy(a) for a in inp["screen"])
    for overlap in (False, True):
        net = net_of()
        opt = make_optimizer(net.parameters(), "Adam", lr=1e-3)
        step = make_dp_screen_train_step(
            mesh, tf, cfg, LossNetScreen(**SCREEN_LOSS), opt, width=W,
            height=W, max_steps=steps, overlap_grads=overlap)
        total = step(net, *pmesh.shard_batch(mesh, (rs, rd, tgt)))
        out[f"screen_overlap{int(overlap)}"] = (
            float(total), _params(net),
            {n: _np(p.grad) for n, p in net.named_parameters()})

    # ray-sharded plain march
    vol = VolumeInterpolationImplicit.make("SPHERE")
    itf = TransferFunctionIdentity.make(absorption=10.0)
    dcfg = RayEvaluationSteppingDvr.make(stepsize=0.05,
                                         enable_early_out=False)
    dsteps = max_steps_bound(vol.box_size.tolist(), 0.05)
    s, d = _rays(dict(distance=1.5), 16, 16)
    render = make_dp_render(mesh, lambda a, b, v, t, c: trace_dvr(
        a, b, v, t, c, dsteps).color)
    out["dp_render"] = (_np(render(s, d, vol, itf, dcfg)),
                        _np(trace_dvr(s, d, vol, itf, dcfg, dsteps).color))

    # ray-sharded per-segment march (its plain version)
    from fvsrn_tpu_torch.ops.fused_dvr import fused_trace_dvr
    fnet = srn_from_arrays(*inp["fused_net"])
    s, d = _rays(dict(pitch=0.2, yaw=0.9, distance=1.6), 32, 16)
    render = make_dp_render(mesh, lambda a, b, n, t: fused_trace_dvr(
        a, b, n, (-0.5, -0.5, -0.5), (1.0, 1.0, 1.0), t, stepsize=1 / 32,
        max_steps=56, seg=8, tile=32, enable_early_out=False))
    with torch.no_grad():
        out["dp_fused"] = _np(render(s, d, fnet, tf.tensor))

    # context-parallel march
    cvol = VolumeInterpolationImplicit.make("MARSCHNER_LOBB")
    ctf = TransferFunctionPiecewiseLinear.make(**CP_TF)
    ccfg = RayEvaluationSteppingDvr.make(stepsize=1 / 48,
                                         enable_early_out=False)
    csteps = max_steps_bound(cvol.box_size.tolist(), 1 / 48)
    s, d = _rays(dict(pitch=0.3, yaw=0.7, distance=1.6), 16, 16)
    got = make_cp_render(mesh, cvol, ctf, ccfg, csteps)(s, d)
    ref = trace_dvr(s, d, cvol, ctf, ccfg, csteps)
    out["cp"] = (_np(got.color), _np(got.depth), _np(ref.color),
                 _np(ref.depth))

    # ray-sharded Monte-Carlo walk, the draws keyed by ray id
    from fvsrn_tpu_torch.phase import PhaseFunctionHenyeyGreenstein
    from fvsrn_tpu_torch.raytracer.montecarlo import (
        RayEvaluationMonteCarlo, trace_mc)
    from fvsrn_tpu_torch.utils.prng import prng_key
    mvol = VolumeInterpolationImplicit.make("SPHERE")
    mtf = TransferFunctionIdentity.make(absorption=8.0)
    mcfg = RayEvaluationMonteCarlo.make(**MC)
    hg = PhaseFunctionHenyeyGreenstein.make(g=0.3)
    s, d = _rays(dict(pitch=0.2, yaw=0.4, distance=1.5), 16, 16)
    rid = torch.arange(s.shape[0], dtype=torch.int64)
    rs_k, rd_k, rid_k = pmesh.shard_batch(mesh, (s, d, rid))
    shard = trace_mc(prng_key(5), rs_k, rd_k, mvol, mtf, hg, mcfg,
                     ray_id=rid_k).color
    whole = trace_mc(prng_key(5), s, d, mvol, mtf, hg, mcfg,
                     ray_id=rid).color
    out["mc"] = (_np(pmesh.gather_batch(mesh, shard)), _np(whole))

    # the data-parallel epoch loop: 4 cameras, 2 epochs
    net = net_of()
    ds = ScreenDataset(*(torch.from_numpy(a) for a in inp["loop"]), W, W)
    _, hist = train_screen_dp(
        net, ds, tf, cfg, LossNetScreen(l1=1.0), make_optimizer(
            net.parameters(), "Adam", lr=1e-3), epochs=2, mesh=mesh,
        max_steps=steps)
    out["loop"] = (hist, _params(net))

    # the trainer, --data_parallel 2, in this group
    from fvsrn_tpu_torch.train import main
    opt = vars(main.init_parser().parse_args(
        [inp["main_out"] if a == "OUT" else a for a in MAIN_ARGS]
        + ["--device", "cpu"]))
    res = main.run(opt)
    out["main"] = (res["history"], _params(res["network"]), res["fused"],
                   res["rank"])
    return out


# ---- the test's side -------------------------------------------------------

def _jax_net(seed=1234):
    import jax.numpy as jnp
    from fvsrn_tpu.models.latent import LatentSpace
    from fvsrn_tpu.models.srn import SceneRepresentationNetwork
    rng = np.random.default_rng(seed)
    latent = LatentSpace(static_grid=jnp.asarray(
        (rng.standard_normal((4, 8, 8, 8)) * 0.1).astype(np.float32)))
    return SceneRepresentationNetwork.make(
        layers="16:16", activation="SnakeAlt:2", num_fourier=4,
        output_mode="density:direct", latent=latent, seed=2)


def _jax_fused_net():
    import jax.numpy as jnp
    from fvsrn_tpu.models.latent import LatentSpace
    from fvsrn_tpu.models.srn import SceneRepresentationNetwork
    rng = np.random.default_rng(99)
    latent = LatentSpace(static_grid=jnp.asarray(
        (rng.standard_normal((8, 8, 8, 8)) * 0.2).astype(np.float32)))
    return SceneRepresentationNetwork.make(
        layers="16:16", activation="SnakeAlt:1", num_fourier=4,
        output_mode="density:direct", latent=latent, seed=9)


def _screen_inputs(rng, n):
    from fvsrn_tpu.camera import CameraOnASphere as JCam
    from fvsrn_tpu.camera import generate_rays as jgen
    rs, rd, tgt = [], [], []
    for i in range(n):
        s, d = jgen(JCam.make(pitch=0.1 * i, yaw=0.3 * i, distance=1.6), W,
                    W)
        rs.append(np.asarray(s).reshape(-1, 3))
        rd.append(np.asarray(d).reshape(-1, 3))
        tgt.append(rng.random((W * W, 4)).astype(np.float32))
    return np.stack(rs), np.stack(rd), np.stack(tgt)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the two ranks' results (rank 0's) and the JAX nets."""
    from tools.export_torch_weights import network_arrays
    rng = np.random.default_rng(1234)
    jnet = _jax_net()
    n = 128
    world = (rng.random((n, 3)).astype(np.float32),
             rng.random((n, 1)).astype(np.float32),
             *(np.zeros((n,), np.float32) for _ in range(3)))
    inp = {"net": network_arrays(jnet), "world": world,
           "screen": _screen_inputs(rng, RANKS),
           "loop": _screen_inputs(rng, 2 * RANKS),
           "fused_net": network_arrays(_jax_fused_net()),
           "main_out": str(tmp_path_factory.mktemp("dp") / "port.npz")}
    got = pmesh.spawn(_job, RANKS, inp, device="cpu")
    return inp, got, jnet


def _jax_tools():
    from fvsrn_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from fvsrn_tpu.train.optimizer import make_optimizer as jopt
    return make_mesh(RANKS), replicate, shard_batch, jopt("Adam", lr=1e-3)


def _assert_leaves(got: dict, jnet, **tol):
    from tools.export_torch_weights import network_arrays
    want, _ = network_arrays(jnet)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **tol)


def test_dp_world_step_matches_jax(case):
    """The world step on two ranks against JAX's on a two-device mesh
    (the single-device step on the whole batch)."""
    from fvsrn_tpu.parallel.train_step import make_dp_world_train_step
    from fvsrn_tpu.train.losses import LossNetWorld as JLoss
    from fvsrn_tpu.train.world import WorldDataset as JData
    inp, got, jnet = case
    mesh, replicate, shard_batch, opt = _jax_tools()
    step = make_dp_world_train_step(mesh, JLoss(mode="density", l1=1.0), opt)
    jnet2, _, total = step(replicate(mesh, jnet),
                           replicate(mesh, opt.init(jnet)),
                           shard_batch(mesh, JData(*inp["world"])))
    np.testing.assert_allclose(got["world"][0], float(total), rtol=1e-5)
    _assert_leaves(got["world"][1], jnet2, atol=1e-5)


def test_dp_screen_step_matches_jax(case):
    """The screen step (L1 + L2 + DSSIM, plain march) on two ranks, one
    camera each, against JAX's."""
    from fvsrn_tpu.parallel.train_step import make_dp_screen_train_step
    from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
    from fvsrn_tpu.train.losses import LossNetScreen as JLoss
    from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
    inp, got, jnet = case
    mesh, replicate, shard_batch, opt = _jax_tools()
    step = make_dp_screen_train_step(
        mesh, JTF.make(**TF), JCfg.make(stepsize=1 / 16,
                                        enable_early_out=False),
        JLoss(**SCREEN_LOSS), opt, width=W, height=W,
        max_steps=max_steps_bound((1.0, 1.0, 1.0), 1 / 16))
    jnet2, _, total = step(replicate(mesh, jnet),
                           replicate(mesh, opt.init(jnet)),
                           *(shard_batch(mesh, a) for a in inp["screen"]))
    total_p, params, _ = got["screen_overlap0"]
    np.testing.assert_allclose(total_p, float(total), rtol=1e-5)
    _assert_leaves(params, jnet2, atol=1e-5)


def test_dp_screen_overlap_grads_bitwise(case):
    """The latent grid's all-reduce started from its leaf's hook inside
    the backward gives bitwise the loss, gradients and update of the
    trailing all-reduce."""
    _, got, _ = case
    off, on = got["screen_overlap0"], got["screen_overlap1"]
    assert on[0] == off[0]
    for k in (1, 2):
        assert sorted(on[k]) == sorted(off[k])
        for name in off[k]:
            np.testing.assert_array_equal(on[k][name], off[k][name],
                                          err_msg=name)
    assert np.abs(off[2]["latent.static_grid"]).max() > 0


def test_dp_render_matches_jax(case):
    """A ray-sharded plain march gathered back in ray order: 1e-6 of the
    single-process march (JAX's bound) and 2e-5 of JAX's."""
    import jax.numpy as jnp
    from fvsrn_tpu.camera import CameraOnASphere as JCam
    from fvsrn_tpu.camera import generate_rays as jgen
    from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
    from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace
    from fvsrn_tpu.transfer import TransferFunctionIdentity as JIdentity
    from fvsrn_tpu.volume.implicit import VolumeInterpolationImplicit as JVol
    _, got, _ = case
    sharded, single = got["dp_render"]
    np.testing.assert_allclose(sharded, single, atol=1e-6)
    vol = JVol.make("SPHERE")
    s, d = jgen(JCam.make(distance=1.5), 16, 16)
    want = jtrace(jnp.reshape(s, (-1, 3)), jnp.reshape(d, (-1, 3)), vol,
                  JIdentity.make(absorption=10.0),
                  JCfg.make(stepsize=0.05, enable_early_out=False),
                  max_steps_bound(np.asarray(vol.box_size), 0.05)).color
    np.testing.assert_allclose(sharded, np.asarray(want), atol=2e-5)
    assert sharded[:, 3].max() > 0.5


def test_dp_fused_render_matches_jax(case):
    """The per-segment march (its plain version) sharded over rays
    against JAX's fused kernel in interpret mode, 1e-5 (JAX's bound)."""
    import jax.numpy as jnp
    from fvsrn_tpu.camera import CameraOnASphere as JCam
    from fvsrn_tpu.camera import generate_rays as jgen
    from fvsrn_tpu.ops.fused_dvr import fused_trace_dvr as jfused
    from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
    _, got, _ = case
    s, d = jgen(JCam.make(pitch=0.2, yaw=0.9, distance=1.6), 32, 16)
    want = jfused(jnp.reshape(s, (-1, 3)), jnp.reshape(d, (-1, 3)),
                  _jax_fused_net(), (-0.5, -0.5, -0.5), (1.0, 1.0, 1.0),
                  JTF.make(**TF).tensor, stepsize=1 / 32, max_steps=56,
                  seg=8, tile=32, enable_early_out=False, interpret=True)
    np.testing.assert_allclose(got["dp_fused"], np.asarray(want),
                               atol=1e-5)


def test_cp_render_matches_jax(case):
    """Context-parallel marching, two spans composited: 2e-6 of the
    single-process march in color, 2e-5 in depth (JAX's bounds), and 2e-5
    of JAX's march."""
    import jax.numpy as jnp
    from fvsrn_tpu.camera import CameraOnASphere as JCam
    from fvsrn_tpu.camera import generate_rays as jgen
    from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
    from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace
    from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
    from fvsrn_tpu.volume.implicit import VolumeInterpolationImplicit as JVol
    _, got, _ = case
    color, depth, ref_color, ref_depth = got["cp"]
    assert ref_color[:, 3].max() > 0.5
    np.testing.assert_allclose(color, ref_color, atol=2e-6)
    np.testing.assert_allclose(depth, ref_depth, atol=2e-5)
    vol = JVol.make("MARSCHNER_LOBB")
    s, d = jgen(JCam.make(pitch=0.3, yaw=0.7, distance=1.6), 16, 16)
    want = jtrace(jnp.reshape(s, (-1, 3)), jnp.reshape(d, (-1, 3)), vol,
                  JTF.make(**CP_TF),
                  JCfg.make(stepsize=1 / 48, enable_early_out=False),
                  max_steps_bound(np.asarray(vol.box_size), 1 / 48))
    np.testing.assert_allclose(color, np.asarray(want.color), atol=2e-5)
    np.testing.assert_allclose(depth, np.asarray(want.depth), atol=1e-4)


def test_cp_render_rejects_early_out():
    """A span cannot see the saturation in front of it: refused before
    any collective, as JAX's."""
    mesh = pmesh.Mesh(0, 2, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="early_out"):
        make_cp_render(mesh, VolumeInterpolationImplicit.make("SPHERE"),
                       TransferFunctionIdentity.make(absorption=10.0),
                       RayEvaluationSteppingDvr.make(stepsize=0.05), 32)


def test_mc_sharded_matches_jax(case):
    """The Monte-Carlo walk sharded over rays, its draws keyed by ray id:
    2e-6 of the single-process walk (JAX's bound), and JAX's sharded walk
    by the port's MC rule (98% of the rays within 1e-3)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from fvsrn_tpu.camera import CameraOnASphere as JCam
    from fvsrn_tpu.camera import generate_rays as jgen
    from fvsrn_tpu.phase import PhaseFunctionHenyeyGreenstein as JHG
    from fvsrn_tpu.raytracer.montecarlo import RayEvaluationMonteCarlo as JMC
    from fvsrn_tpu.raytracer.montecarlo import trace_mc as jtrace_mc
    from fvsrn_tpu.transfer import TransferFunctionIdentity as JIdentity
    from fvsrn_tpu.volume.implicit import VolumeInterpolationImplicit as JVol
    _, got, _ = case
    sharded, single = got["mc"]
    np.testing.assert_allclose(sharded, single, atol=2e-6)
    assert sharded[:, 3].max() > 0.1
    mesh = _jax_tools()[0]
    s, d = jgen(JCam.make(pitch=0.2, yaw=0.4, distance=1.5), 16, 16)
    rs, rd = jnp.reshape(s, (-1, 3)), jnp.reshape(d, (-1, 3))
    rid = jnp.arange(rs.shape[0], dtype=jnp.uint32)
    vol, tf, cfg, hg = (JVol.make("SPHERE"), JIdentity.make(absorption=8.0),
                        JMC.make(**MC), JHG.make(g=0.3))

    def local(rs, rd, rid):
        return jtrace_mc(jax.random.PRNGKey(5), rs, rd, vol, tf, hg, cfg,
                         ray_id=rid).color

    want = np.asarray(jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P("data"),) * 3, out_specs=P("data"),
        check_vma=False))(rs, rd, rid))
    close = np.all(np.abs(sharded - want) < 1e-3, axis=-1)
    assert close.mean() >= 0.98, (~close).sum()


def test_train_screen_dp_matches_jax(case):
    """Two epochs of the data-parallel loop (4 cameras, 2 a step, JAX's
    camera order) against JAX's ``train_screen_dp``: history rtol 1e-5,
    parameters 1e-5."""
    from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
    from fvsrn_tpu.train.losses import LossNetScreen as JLoss
    from fvsrn_tpu.train.screen import ScreenDataset as JDataset
    from fvsrn_tpu.train.screen import train_screen_dp as jtrain
    from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
    inp, got, jnet = case
    mesh, _, _, opt = _jax_tools()
    jnet2, hist = jtrain(
        jnet, JDataset(*inp["loop"], W, W), JTF.make(**TF),
        JCfg.make(stepsize=1 / 16, enable_early_out=False),
        JLoss(l1=1.0), opt, epochs=2, mesh=mesh,
        max_steps=max_steps_bound((1.0, 1.0, 1.0), 1 / 16))
    np.testing.assert_allclose(got["loop"][0], hist, rtol=1e-5)
    _assert_leaves(got["loop"][1], jnet2, atol=1e-5)


def test_trainer_data_parallel_matches_jax(case, tmp_path):
    """``train.main.run --data_parallel 2`` (2 cameras at 16^2, 1/32, 2
    epochs, the fused route's plain version) run by both ranks against
    the JAX ``run`` on a two-device mesh: history rtol 1e-4, every leaf
    within a relative norm error of 1e-4 (the trainer's bounds); rank 0
    alone wrote the run file."""
    from fvsrn_tpu.train import main as jmain
    from fvsrn_tpu_torch.train.checkpoints import load_arrays
    from tools.export_torch_weights import network_arrays
    inp, got, _ = case
    hist, params, fused, rank = got["main"]
    jopt = vars(jmain.init_parser().parse_args(
        [str(tmp_path / "jax.hdf5") if a == "OUT" else a
         for a in MAIN_ARGS]))
    want = jmain.run(jopt)
    assert fused and want["fused"] and rank == 0
    np.testing.assert_allclose(hist, want["history"], rtol=1e-4)
    jparams, _ = network_arrays(want["network"])
    assert sorted(params) == sorted(jparams)
    for name in jparams:
        rel = (np.linalg.norm(params[name] - jparams[name])
               / np.linalg.norm(jparams[name]))
        assert rel <= 1e-4, (name, rel)
    _, meta = load_arrays(inp["main_out"])
    assert meta["history"] == hist


def test_trainer_spawns_its_ranks(tmp_path):
    """Outside a process group, ``run`` with ``--data_parallel 2``
    spawns its two ranks and returns rank 0's result (1 epoch of the same
    configuration, plain march)."""
    from fvsrn_tpu_torch.train import main
    args = [str(tmp_path / "out.npz") if a == "OUT" else a
            for a in MAIN_ARGS]
    args[args.index("-i") + 1] = "1"
    opt = vars(main.init_parser().parse_args(args + ["--device", "cpu",
                                                     "--no_fused"]))
    res = main.run(opt)
    assert res["rank"] == 0 and not res["fused"]
    assert len(res["history"]) == 1 and np.isfinite(res["history"][0])
    assert os.path.exists(tmp_path / "out.npz")
    assert not torch.distributed.is_initialized()


def test_trainer_under_torchrun_needs_its_world_size(tmp_path, monkeypatch):
    """Under ``torchrun`` (rank and world size in the environment) the
    trainer joins the launcher's group, whose size must be the
    ``--data_parallel`` count: a world of 1 refuses 2 before any group is
    made."""
    from fvsrn_tpu_torch.train import main
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    args = [str(tmp_path / "out.npz") if a == "OUT" else a
            for a in MAIN_ARGS]
    opt = vars(main.init_parser().parse_args(args + ["--device", "cpu"]))
    with pytest.raises(ValueError, match="1 ranks, not 2"):
        main.run(opt)
    assert not torch.distributed.is_initialized()
