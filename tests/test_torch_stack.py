"""Port parity, the rest of the training stack: L-BFGS (``torch.optim.LBFGS``
with the strong-Wolfe line search against optax's ``lbfgs`` with its
zoom line search on the same world-space fit from the same weights: both
losses below a quarter of the start in 20 iterations; another algorithm,
so no iterate is compared), the trainer's refusal of ``--optimizer
lbfgs`` where the JAX trainer fails at its first update, the screen
dataset's ``.npz`` cache and its reuse rule, ``inference.compare_modes``
against the JAX package's (32x32, 1/128, the PLAIN32 entry within 2% of
JAX's), ``--tensorboard`` (``loss/total`` at each epoch, and the run
going on without the package), and ``trace_dvr``'s ``step_offset`` and
``tmin_in`` against JAX's (2e-5, the plain march's bound). CPU only."""
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.inference import LoadedModel as JLoadedModel
from fvsrn_tpu.inference import compare_modes as jcompare_modes
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace
from fvsrn_tpu.scenes import dense_scene as jdense_scene
from fvsrn_tpu.train.losses import LossNetWorld as JLoss
from fvsrn_tpu.train.optimizer import make_optimizer as jmake_optimizer
from fvsrn_tpu.train.world import WorldDataset as JData
from fvsrn_tpu.train.world import evaluate_world as jevaluate
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu.volume.implicit import VolumeInterpolationImplicit as JVol
from fvsrn_tpu_torch.camera import CameraOnASphere
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.inference import LoadedModel, compare_modes
from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                           max_steps_bound, trace_dvr)
from fvsrn_tpu_torch.scenes import dense_scene
from fvsrn_tpu_torch.train import main, screen
from fvsrn_tpu_torch.train.losses import LossNetWorld
from fvsrn_tpu_torch.train.optimizer import make_optimizer
from fvsrn_tpu_torch.train.world import WorldDataset, evaluate_world
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from fvsrn_tpu_torch.volume.implicit import VolumeInterpolationImplicit
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
TF = dict(rgb=[[0.9, 0.4, 0.1], [1.0, 1.0, 0.6]], opacity=[0.0, 20.0],
          positions=[0.0, 1.0])
LBFGS_ITERS = 20
WORLD_ARGS = ["IMPLICIT:MARSCHNER_LOBB", "OUT", "--mode", "world",
              "--layers", "16:16", "--fouriercount", "4", "--samples",
              "1024", "--batch_size", "512", "-i", "2", "--device", "cpu"]


def _world_fit():
    """A 16:16 SRN (sigmoid density head) and 512 seeded positions of
    MARSCHNER_LOBB with their densities, in both packages."""
    jnet = JSRN.make(layers="16:16", activation="SnakeAlt:2",
                     num_fourier=4, output_mode="density", seed=3)
    pos = np.random.default_rng(8).random((512, 3)).astype(np.float32)
    vol = VolumeInterpolationImplicit.make("MARSCHNER_LOBB")
    with torch.no_grad():
        dens = vol.eval_density(vol.box_min + torch.from_numpy(pos)
                                * vol.box_size)[0][:, None].numpy()
    zeros = np.zeros((512,), np.float32)
    return jnet, (pos, dens, zeros, zeros, zeros)


def test_lbfgs_fits_like_optax():
    """``make_optimizer(..., "lbfgs")`` is ``torch.optim.LBFGS`` with the
    strong-Wolfe search, stepped through a closure; optax's ``lbfgs``
    driven by ``value_and_grad_from_state`` as its documentation does.
    One iteration a step, 20 steps, L2 world loss from the same weights
    (measured on the CPU: optax 7.5%, the port 7.4% of the start):
    each falls below a quarter of its start."""
    jnet, data = _world_fit()
    jloss = JLoss(mode="density", l1=0.0, l2=1.0)
    jbatch = JData(*(jnp.asarray(a) for a in data))

    def jfn(n):
        return jevaluate(n, jbatch, jloss)[0]

    jopt = jmake_optimizer("lbfgs")
    value_and_grad = optax.value_and_grad_from_state(jfn)

    @jax.jit
    def jstep(n, state):
        value, grad = value_and_grad(n, state=state)
        updates, state = jopt.update(grad, state, n, value=value, grad=grad,
                                     value_fn=jfn)
        return optax.apply_updates(n, updates), state

    state = jopt.init(jnet)
    jstart = float(jfn(jnet))
    for _ in range(LBFGS_ITERS):
        jnet, state = jstep(jnet, state)
    jend = float(jfn(jnet))

    net = srn_from_arrays(*network_arrays(_world_fit()[0]))
    loss = LossNetWorld(mode="density", l1=0.0, l2=1.0)
    batch = WorldDataset(*(torch.from_numpy(a) for a in data))
    # one iteration a step, its line search up to 25 evaluations
    opt, sched = make_optimizer(net.parameters(), "lbfgs", max_iter=1,
                                max_eval=25)
    assert isinstance(opt, torch.optim.LBFGS)
    assert opt.defaults["line_search_fn"] == "strong_wolfe"

    def closure():
        opt.zero_grad()
        total = evaluate_world(net, batch, loss)[0]
        total.backward()
        return total

    start = float(closure().detach())
    for _ in range(LBFGS_ITERS):
        opt.step(closure)
        sched.step()
    with torch.no_grad():
        end = float(evaluate_world(net, batch, loss)[0])
    np.testing.assert_allclose(start, jstart, rtol=1e-5)
    assert jend < 0.25 * jstart, (jstart, jend)
    assert end < 0.25 * start, (start, end)


def test_trainer_refuses_lbfgs_where_jax_fails(tmp_path):
    """The JAX trainer's steps call ``optimizer.update(grads, state,
    params)``, which optax's ``lbfgs`` refuses (it needs the value, the
    gradient and the value function): TypeError at the first update. The
    port's trainer refuses the option before its first step."""
    jnet, data = _world_fit()
    jopt = jmake_optimizer("lbfgs")
    grads = jax.jit(jax.grad(lambda n: jevaluate(
        n, JData(*(jnp.asarray(a) for a in data)),
        JLoss(mode="density", l1=1.0))[0]))(jnet)
    with pytest.raises(TypeError, match="value_fn"):
        jopt.update(grads, jopt.init(jnet), jnet)
    opt = vars(main.init_parser().parse_args(
        [str(tmp_path / "x.npz") if a == "OUT" else a for a in WORLD_ARGS]
        + ["-o", "LBFGS"]))
    with pytest.raises(ValueError, match="lbfgs"):
        main.run(opt)
    assert not (tmp_path / "x.npz").exists()


def test_screen_dataset_cache(tmp_path):
    """Written after rendering (an ``.npz`` under the name given), read
    back when the camera count, width and height match (nothing else is
    compared), rendered again and rewritten when one differs."""
    vol = VolumeInterpolationImplicit.make("MARSCHNER_LOBB")
    tf = TransferFunctionPiecewiseLinear.make(**TF)
    cfg = RayEvaluationSteppingDvr.make(stepsize=1 / 16)
    path = str(tmp_path / "gt.cache")
    kw = dict(num_cameras=2, width=8, height=8, device="cpu",
              cache_path=path)
    first = screen.build_screen_dataset(vol, tf, cfg, **kw)
    plain = screen.build_screen_dataset(vol, tf, cfg, num_cameras=2,
                                        width=8, height=8, device="cpu")
    for a, b in zip(first[:3], plain[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with np.load(path) as f:
        arrays = dict(f)
    arrays["targets"] = np.full_like(arrays["targets"], 0.25)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    again = screen.build_screen_dataset(vol, tf, cfg, **dict(
        kw, distance=3.0))
    assert bool((again.targets == 0.25).all())
    torch.testing.assert_close(again.ray_start, first.ray_start)
    wider = screen.build_screen_dataset(vol, tf, cfg, **dict(kw, width=16))
    assert wider.targets.shape == (2, 128, 4)
    assert not bool((wider.targets == 0.25).all())
    with np.load(path) as f:
        assert int(f["width"]) == 16 and f["targets"].shape == (2, 128, 4)


def test_compare_modes_matches_jax():
    """The MSE table of FUSED (the port's plain version of row 1) and
    PLAIN32 on the dense flagship at 32x32, 1/128: FUSED's entry 0, and
    PLAIN32's within 2% of JAX's (each package's bf16-table FUSED against
    its own float32 march)."""
    _, jtf, ckpt = jdense_scene()
    jm = JLoadedModel.from_checkpoint(ckpt, tf=jtf)
    jm.config = JCfg.make(stepsize=1 / 128)
    _, tf, npz = dense_scene()
    m = LoadedModel.from_checkpoint(
        npz, tf=tf, config=RayEvaluationSteppingDvr.make(stepsize=1 / 128))
    cam = dict(pitch=0.3, yaw=0.5, distance=1.6)
    want = jcompare_modes(jm, JCam.make(**cam), 32, 32)
    got = compare_modes(m, CameraOnASphere.make(**cam), 32, 32,
                        device="cpu")
    assert sorted(got) == ["FUSED", "PLAIN32"] and got["FUSED"] == 0.0
    assert 0 < got["PLAIN32"] < 1e-3
    np.testing.assert_allclose(got["PLAIN32"], want["PLAIN32"], rtol=2e-2)


class _Writer:
    """A stand-in ``SummaryWriter`` that records its calls."""
    calls = []

    def __init__(self, logdir):
        self.calls.append(("open", logdir))

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, value, step))

    def close(self):
        self.calls.append(("close",))


def test_tensorboard_logs_and_falls_back(tmp_path, monkeypatch, capsys):
    """``--tensorboard DIR``: ``loss/total`` at every epoch through
    ``SummaryWriter(DIR)``; where ``torch.utils.tensorboard`` cannot be
    imported, the JAX package's line on stderr and the run goes on."""
    args = [str(tmp_path / "a.npz") if a == "OUT" else a
            for a in WORLD_ARGS] + ["--tensorboard", str(tmp_path / "tb")]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=_Writer))
    _Writer.calls.clear()
    out = main.run(vars(main.init_parser().parse_args(args)))
    assert _Writer.calls == (
        [("open", str(tmp_path / "tb"))]
        + [("loss/total", v, i) for i, v in enumerate(out["history"])]
        + [("close",)])
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    capsys.readouterr()
    out = main.run(vars(main.init_parser().parse_args(args)))
    assert "tensorboard unavailable; continuing without" in \
        capsys.readouterr().err
    assert len(out["history"]) == 2 and (tmp_path / "a.npz").exists()


@pytest.mark.parametrize("case", ["step_offset", "tmin_in", "both"])
def test_trace_dvr_offset_and_entry_clip_match_jax(case):
    """``step_offset`` marches steps [offset, offset + max_steps),
    ``tmin_in`` starts each ray at max(tmin, tmin_in) with a fresh
    previous density; against JAX's ``trace_dvr``, checkpointed in chunks
    too."""
    jcam = JCam.make(pitch=0.3, yaw=0.7, distance=1.6)
    s, d = jgenerate_rays(jcam, 16, 16)
    s, d = np.asarray(s).reshape(-1, 3), np.asarray(d).reshape(-1, 3)
    tmin_in = np.random.default_rng(11).uniform(
        0.5, 1.4, (s.shape[0], 1)).astype(np.float32)
    kw = {}
    if case in ("step_offset", "both"):
        kw["step_offset"] = 17
    jkw = dict(kw)
    if case in ("tmin_in", "both"):
        kw["tmin_in"] = torch.from_numpy(tmin_in)
        jkw["tmin_in"] = jnp.asarray(tmin_in)
    steps = 30
    want = jtrace(jnp.asarray(s), jnp.asarray(d), JVol.make("MARSCHNER_LOBB"),
                  JTF.make(**TF), JCfg.make(stepsize=1 / 48,
                                            enable_early_out=False),
                  steps, **jkw)
    vol = VolumeInterpolationImplicit.make("MARSCHNER_LOBB")
    tf = TransferFunctionPiecewiseLinear.make(**TF)
    cfg = RayEvaluationSteppingDvr.make(stepsize=1 / 48,
                                        enable_early_out=False)
    rs, rd = torch.from_numpy(s), torch.from_numpy(d)
    got = trace_dvr(rs, rd, vol, tf, cfg, steps, **kw)
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color),
                               atol=2e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               atol=1e-4)
    assert float(got.color[:, 3].max()) > 0.1
    rs.requires_grad_(True)
    chunked = trace_dvr(rs, rd, vol, tf, cfg, steps, checkpoint_chunk=7,
                        **kw)
    torch.testing.assert_close(chunked.color.detach(), got.color)
    full = trace_dvr(rs.detach(), rd, vol, tf, cfg,
                     max_steps_bound((1.0, 1.0, 1.0), 1 / 48))
    if case == "step_offset":
        assert not torch.allclose(got.color, full.color)
