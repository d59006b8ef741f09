"""Port parity, model: latent trilerp, SRN forward and the network volume
of ``fvsrn_tpu_torch`` against ``fvsrn_tpu`` (CPU, atol 1e-5), on small
random networks and on the trained flagship."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.latent import grid_sample_3d as jgrid_sample
from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.scenes import dense_scene as jdense_scene
from fvsrn_tpu.train.checkpoints import RunCheckpoint
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.models.latent import grid_sample_3d
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.scenes import dense_scene
from fvsrn_tpu_torch.train.checkpoints import load_weights
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
ATOL = 1e-5


def port(jnet):
    return srn_from_arrays(*network_arrays(jnet))


def small_net(seed=3, output_mode="density:direct", latent=True):
    rng = np.random.default_rng(seed)
    lat = JLatent(static_grid=(rng.standard_normal((8, 6, 5, 7)) * 0.3)
                  .astype(np.float32)) if latent else JLatent()
    return JSRN.make(layers="32:32", activation="SnakeAlt:2",
                     num_fourier=6, output_mode=output_mode, latent=lat,
                     seed=seed)


def test_grid_sample_3d(rng):
    grid = rng.standard_normal((5, 4, 6, 7)).astype(np.float32)
    pos = rng.uniform(-0.2, 1.2, (300, 3)).astype(np.float32)
    want = np.asarray(jgrid_sample(jnp.asarray(grid), jnp.asarray(pos)))
    got = grid_sample_3d(torch.from_numpy(grid),
                         torch.from_numpy(pos)).numpy()
    assert got.shape == (300, 5)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("output_mode", ["density:direct", "density",
                                         "rgbo", "rgbo:exp"])
@pytest.mark.parametrize("latent", [True, False])
def test_srn_forward_small(output_mode, latent, rng):
    jnet = small_net(output_mode=output_mode, latent=latent)
    x = rng.random((257, 3)).astype(np.float32)
    want = np.asarray(jnet(jnp.asarray(x)))
    with torch.no_grad():
        got = port(jnet)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.fixture(scope="module")
def flagship():
    _, _, ckpt = jdense_scene()
    with RunCheckpoint(ckpt, "r") as ck:
        jnet = ck.load_weights()
    return jnet, load_weights(dense_scene()[2])


def test_srn_forward_flagship(flagship, rng):
    jnet, net = flagship
    x = rng.random((1000, 3)).astype(np.float32)
    want = np.asarray(jnet(jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert want.std() > 0.05  # a trained field, not a constant


@pytest.mark.parametrize("which", ["small", "flagship"])
def test_eval_density(which, flagship, rng):
    if which == "small":
        jnet = small_net()
        net = port(jnet)
    else:
        jnet, net = flagship
    bmin, bsz = (-0.5, -0.4, -0.6), (1.0, 0.8, 1.2)
    pos = rng.uniform(-0.7, 0.7, (20, 9, 3)).astype(np.float32)
    jv, jin = JVolume.make(jnet, box_min=bmin, box_size=bsz).eval_density(
        jnp.asarray(pos))
    with torch.no_grad():
        v, inside = VolumeInterpolationNetwork(net, bmin, bsz).eval_density(
            torch.from_numpy(pos))
    assert v.shape == (20, 9)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(jin))
