"""Port parity, world-space training (``fvsrn_tpu_torch/train/{sampling,
world,importance,main}.py`` and ``transfer.evaluate``): the port against
the JAX package on the same seeds and weights. Positions drawn from keys
(JAX's ``random.uniform`` bits, ``utils.prng``), the Halton and plastic
sequences, the epoch permutations and the positions importance sampling
accepts are exact; training (losses per
epoch and final weights, from weights carried across by
``convert.srn_from_arrays``) within 1e-4 relative. Densities are within
1e-6 and TF colors within the TF's slope times that. CPU only, small
sizes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu import transfer as jtransfer
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import VolumeInterpolationNetwork as JVol
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.train import importance as jimp
from fvsrn_tpu.train import main as jmain
from fvsrn_tpu.train import sampling as jsampling
from fvsrn_tpu.train import world as jworld
from fvsrn_tpu.train.losses import LossNetWorld as JLoss
from fvsrn_tpu.train.optimizer import make_optimizer as jmake_optimizer
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu.volume.implicit import VolumeInterpolationImplicit as JImplicit
from fvsrn_tpu_torch import transfer
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.train import importance, main, sampling, world
from fvsrn_tpu_torch.train.losses import LossNetWorld
from fvsrn_tpu_torch.train.optimizer import make_optimizer
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from fvsrn_tpu_torch.utils import prng
from fvsrn_tpu_torch.volume.implicit import VolumeInterpolationImplicit
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
CPU = "cpu"
TF = dict(rgb=[[0.9, 0.4, 0.1], [0.2, 0.5, 1.0], [1.0, 1.0, 0.6]],
          opacity=[0.0, 7.0, 20.0], positions=[0.0, 0.4, 1.0])
# densities within 1e-6 of JAX's (XLA fuses the implicit field's
# multiply-adds); the TF's absorption scales that by its steepest slope,
# 13 / 0.6 per unit density, so colors are held to 22e-6
DENSITY_ATOL = 1e-6
COLOR_ATOL = 22 * DENSITY_ATOL


def volumes():
    return (JImplicit.make("MARSCHNER_LOBB"),
            VolumeInterpolationImplicit.make("MARSCHNER_LOBB"))


def nets(output_mode="density:direct", seed=3):
    """A narrow net in both packages: 16:16 SnakeAlt:2, 4 Fourier
    features, a 4x8^3 latent grid."""
    grid = (np.random.default_rng(seed).standard_normal((4, 8, 8, 8))
            * 0.3).astype(np.float32)
    jnet = JSRN.make(layers="16:16", activation="SnakeAlt:2",
                     num_fourier=4, output_mode=output_mode,
                     latent=JLatent(static_grid=jnp.asarray(grid)),
                     seed=seed)
    return jnet, srn_from_arrays(*network_arrays(jnet))


def rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_transfer_evaluate_and_max_absorption():
    """Densities around and outside [density_min, density_max], with a
    stepsize; the largest absorption of the control points."""
    d = np.random.default_rng(0).uniform(-0.2, 1.3, (500, 1)).astype(
        np.float32)
    jtf, tf = JTF.make(**TF), TransferFunctionPiecewiseLinear.make(**TF)
    for lo, hi, ss in ((0.0, 1.0, None), (0.1, 0.9, 0.25)):
        want = np.asarray(jtransfer.evaluate(jtf, jnp.asarray(d), lo, hi,
                                             stepsize=ss))
        got = transfer.evaluate(tf, torch.from_numpy(d), lo, hi,
                                stepsize=ss).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert float(tf.max_absorption()) == float(jtf.max_absorption()) == 20.0


@pytest.mark.parametrize("sampler", ["random", "plastic", "halton"])
def test_get_sampled_positions(sampler):
    """All three samplers exact: 1,000 positions from index 5 (the key
    of "random" is prng_key(5) by default, and an explicit one)."""
    want = jsampling.get_sampled_positions(sampler, 1000, 3, 5)
    got = sampling.get_sampled_positions(sampler, 1000, 3, 5, device=CPU)
    assert got.dtype == torch.float32 and got.shape == (1000, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if sampler == "random":
        want = jsampling.get_sampled_positions(
            sampler, 77, 3, key=jax.random.PRNGKey(9))
        got = sampling.get_sampled_positions(sampler, 77, 3,
                                             key=prng.prng_key(9), device=CPU)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("with_tf", [False, True])
def test_build_world_dataset(with_tf):
    """Density targets (N, 1) and rgbo targets (N, 4) through the TF with
    a stepsize, from random positions of a key."""
    jvol, vol = volumes()
    jtf, tf = JTF.make(**TF), TransferFunctionPiecewiseLinear.make(**TF)
    want = jworld.build_world_dataset(
        jvol, 2000, sampler="random", key=jax.random.PRNGKey(4),
        tf=jtf if with_tf else None, stepsize=0.5, time=0.25)
    got = world.build_world_dataset(
        vol, 2000, sampler="random", key=prng.prng_key(4),
        tf=tf if with_tf else None, stepsize=0.5, time=0.25, device=CPU)
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(want.positions))
    assert got.targets.shape == (2000, 4 if with_tf else 1)
    np.testing.assert_allclose(got.targets.numpy(), np.asarray(want.targets),
                               rtol=0,
                               atol=COLOR_ATOL if with_tf else DENSITY_ATOL)
    for name in ("tf", "time", "ensemble"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


@pytest.mark.parametrize("output_mode", ["density:direct", "rgbo"])
def test_train_world_epochs_matches_jax(output_mode):
    """Two epochs of 1,024 halton samples in batches of 256 (Adam, lr
    1e-2, a StepLR decay every 3 steps): per-epoch losses and final
    weights within 1e-4 relative."""
    jvol, vol = volumes()
    rgbo = output_mode == "rgbo"
    jtf, tf = JTF.make(**TF), TransferFunctionPiecewiseLinear.make(**TF)
    jnet, net = nets(output_mode)
    jds = jworld.build_world_dataset(jvol, 1024, sampler="halton",
                                     tf=jtf if rgbo else None)
    ds = world.build_world_dataset(vol, 1024, sampler="halton",
                                   tf=tf if rgbo else None, device=CPU)
    np.testing.assert_allclose(ds.targets.numpy(), np.asarray(jds.targets),
                               rtol=0, atol=COLOR_ATOL)
    mode = "rgbo" if rgbo else "density"
    jnet, jhist = jworld.train_world_epochs(
        jnet, jds, JLoss(mode=mode), jmake_optimizer("Adam", lr=1e-2,
                                                     lr_step=3),
        batch_size=256, epochs=2, scan_epoch=False)
    seen = []
    net, hist = world.train_world_epochs(
        net, ds, LossNetWorld(mode=mode),
        lambda p: make_optimizer(p, "Adam", lr=1e-2, lr_step=3),
        batch_size=256, epochs=2,
        callback=lambda e, nw, lv: seen.append((e, lv)))
    assert seen == list(enumerate(hist)) and hist[1] < hist[0]
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    jparams, _ = network_arrays(jnet)
    for name, p in net.named_parameters():
        assert rel(p.detach().numpy(), jparams[name]) <= 1e-4, name


def test_train_world_epochs_aborts_on_nan():
    """A non-finite epoch loss raises FloatingPointError, as in JAX."""
    _, vol = volumes()
    _, net = nets()
    ds = world.build_world_dataset(vol, 64, sampler="plastic", device=CPU)
    ds = ds._replace(targets=torch.full_like(ds.targets, float("nan")))
    with pytest.raises(FloatingPointError):
        world.train_world_epochs(net, ds, LossNetWorld(),
                                 lambda p: make_optimizer(p), batch_size=32,
                                 epochs=1)


@pytest.mark.parametrize("with_tf", [False, True])
def test_importance_sampling_matches_jax(with_tf):
    """500 accepted positions from 4x candidates a round: the accepted
    positions exact (uniform bits, a host nonzero), densities within 1e-6
    and colors within COLOR_ATOL."""
    jvol, vol = volumes()
    jtf, tf = JTF.make(**TF), TransferFunctionPiecewiseLinear.make(**TF)
    want = jimp.importance_sampling(jax.random.PRNGKey(2), jvol, 500,
                                    tf=jtf if with_tf else None,
                                    min_prob=0.05, oversample=2)
    got = importance.importance_sampling(prng.prng_key(2), vol, 500,
                                         tf=tf if with_tf else None,
                                         min_prob=0.05, oversample=2,
                                         device=CPU)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=DENSITY_ATOL)
    if with_tf:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=COLOR_ATOL)
    else:
        assert got[2] is None and want[2] is None


def test_loss_probability_grid_and_grid_sampling_match_jax():
    """The per-voxel |network - reference| grid at 8^3 (1e-6), then 400
    positions accepted against it (exact) with their densities."""
    jvol, vol = volumes()
    jnet, net = nets()
    jgrid = np.asarray(jimp.loss_probability_grid(JVol.make(jnet), jvol,
                                                  resolution=8, chunk=200))
    grid = importance.loss_probability_grid(VolumeInterpolationNetwork(net),
                                            vol, resolution=8, chunk=200,
                                            device=CPU)
    assert grid.shape == (8, 8, 8)
    np.testing.assert_allclose(grid.detach().numpy(), jgrid, rtol=0,
                               atol=1e-6)
    want = jimp.importance_sampling_with_probability_grid(
        jax.random.PRNGKey(8), jvol, jgrid, 400, min_prob=0.05)
    got = importance.importance_sampling_with_probability_grid(
        prng.prng_key(8), vol, torch.from_numpy(jgrid.copy()), 400,
        min_prob=0.05,
        device=CPU)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=DENSITY_ATOL)


ARGS = ["IMPLICIT:MARSCHNER_LOBB", "OUT", "--mode", "world",
        "--layers", "16:16", "--fouriercount", "4",
        "--volumetric_features_channels", "4",
        "--volumetric_features_resolution", "8",
        "--volumetric_features_std", "0.3", "--samples", "1024",
        "--batch_size", "256", "-lr", "0.01", "--seed", "6"]


@pytest.mark.parametrize("extra", [
    ["-i", "2"],
    ["-i", "3", "--sampler", "random", "--importance", "0.5",
     "--rebuild_dataset", "1"],
    ["-i", "2", "--sampler", "plastic", "--outputmode", "rgbo"]])
def test_trainer_world_matches_jax(extra, tmp_path):
    """``train.main.run`` in world mode against the JAX ``run`` on a tiny
    configuration: halton, plastic with an rgbo head, and random with an
    importance-sampled half and a dataset rebuilt from the loss grid every
    epoch. Loss history within 1e-4 relative."""
    args = ARGS + extra
    want = jmain.run(vars(jmain.init_parser().parse_args(
        [str(tmp_path / "jax.hdf5") if a == "OUT" else a for a in args])))
    got = main.run(vars(main.init_parser().parse_args(
        [str(tmp_path / "port.npz") if a == "OUT" else a for a in args]
        + ["--device", "cpu"])))
    assert "fused" not in got
    assert len(got["history"]) == int(extra[1])
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-4)
    assert np.isfinite(got["history"]).all()
