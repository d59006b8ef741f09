"""The flagship's weights as the port reads them: the committed ``.npz``
export equals the JAX checkpoint's leaves exactly, and
``convert.srn_from_arrays`` rebuilds every layer from it; the other
kinds of network the fused renders take (color heads, direction input,
wide latent grids) cross the same way and evaluate alike."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.scenes import dense_scene as jdense_scene
from fvsrn_tpu.scenes import sparse_scene as jsparse_scene
from fvsrn_tpu.train.checkpoints import RunCheckpoint
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.scenes import dense_scene, sparse_scene
from fvsrn_tpu_torch.train.checkpoints import load_arrays, load_weights
from tools.export_torch_weights import _key_name, export, save_network


@pytest.fixture(scope="module")
def jnet():
    with RunCheckpoint(jdense_scene()[2], "r") as ck:
        return ck.load_weights()


def test_npz_equals_checkpoint_leaves(jnet):
    arrays, meta = load_arrays(dense_scene()[2])
    leaves, _ = jax.tree_util.tree_flatten_with_path(jnet)
    assert set(arrays) == {_key_name(p) for p, _ in leaves}
    for path, leaf in leaves:
        a = arrays[_key_name(path)]
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(leaf))
    assert meta["output_mode"] == jnet.output_mode == "density:direct"
    assert meta["has_direction"] is False
    assert [(d["activation"], d["activation_param"]) for d in meta["layers"]
            ] == [(l.activation, l.activation_param) for l in jnet.layers]


def test_srn_from_arrays_rebuilds_every_layer(jnet):
    net = load_weights(dense_scene()[2])
    assert len(net.layers) == len(jnet.layers) == 4
    for layer, jl in zip(net.layers, jnet.layers):
        np.testing.assert_array_equal(layer.weight.detach().numpy(),
                                      np.asarray(jl.weight))
        np.testing.assert_array_equal(layer.bias.detach().numpy(),
                                      np.asarray(jl.bias))
        assert (layer.activation, layer.activation_param) == (
            jl.activation, jl.activation_param)
    assert tuple(net.layers[0].weight.shape) == (32, 47)
    np.testing.assert_array_equal(
        net.input.fourier_matrix.detach().numpy(),
        np.asarray(jnet.input.fourier_matrix))
    np.testing.assert_array_equal(net.latent.static_grid.detach().numpy(),
                                  np.asarray(jnet.latent.static_grid))
    assert tuple(net.latent.static_grid.shape) == (16, 32, 32, 32)
    assert net.output_mode == jnet.output_mode


def test_export_reproduces_committed_npz(tmp_path):
    out = str(tmp_path / "w.npz")
    export(jdense_scene()[2], out)
    got, meta = load_arrays(out)
    want, want_meta = load_arrays(dense_scene()[2])
    assert meta == want_meta and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_shell_export_reproduces_committed_npz(tmp_path):
    """The sparse flagship crosses the same way: ``sparse_scene()`` names
    the committed ``.npz``, which the export tool reproduces from the run
    file bit for bit."""
    path = sparse_scene()[2]
    assert path.endswith("flagship_shell_torch.npz")
    out = str(tmp_path / "shell.npz")
    export(jsparse_scene()[2], out)
    got, meta = load_arrays(out)
    want, want_meta = load_arrays(path)
    assert meta == want_meta and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_shell_density_matches_jax():
    """The port's density of the sparse flagship equals the JAX package's
    at seeded positions over the box and a little beyond (atol 1e-5)."""
    with RunCheckpoint(jsparse_scene()[2], "r") as ck:
        jnet = ck.load_weights()
    net = load_weights(sparse_scene()[2])
    assert tuple(net.latent.static_grid.shape) == (16, 32, 32, 32)
    assert net.output_mode == jnet.output_mode == "density:direct"
    pos = np.random.default_rng(9).uniform(-0.55, 0.55, (4099, 3)).astype(
        np.float32)
    want, _ = JVolume.make(jnet).eval_density(jnp.asarray(pos),
                                              jnp.zeros((4099, 3)))
    with torch.no_grad():
        got, _ = VolumeInterpolationNetwork(net).eval_density(
            torch.tensor(pos))
    assert float(np.asarray(want).max()) > 0.3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_srn_from_arrays_rejects_unported_leaves():
    """A leaf the port has no place for raises; the keyframed grids and
    latent vectors have one now (tests/test_torch_latent.py)."""
    arrays, meta = load_arrays(dense_scene()[2])
    arrays["latent.time_grid"] = np.zeros((2, 4, 4, 4, 4), np.float32)
    srn_from_arrays(arrays, meta)
    arrays["latent.unknown_leaf"] = np.zeros((2, 4), np.float32)
    with pytest.raises(NotImplementedError):
        srn_from_arrays(arrays, meta)


KINDS = {
    "rgbo": dict(output_mode="rgbo"),
    "rgbo_direct": dict(output_mode="rgbo:direct"),
    "rgbo_exp": dict(output_mode="rgbo:exp"),
    "direction_fourier": dict(use_direction=True,
                              disable_direction_in_fourier=False),
    "direction_plain": dict(use_direction=True),
    "grid20": dict(channels=20),
    "grid40_sine": dict(channels=40, activation="Sine:3"),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_network_kinds_cross_through_npz(kind, tmp_path):
    """Each kind, written by the export tool and read by
    ``load_weights``: the same leaves and the same ``eval_density`` as the
    JAX network at random positions and directions (float32, atol 1e-5)."""
    spec = dict(KINDS[kind])
    channels = spec.pop("channels", 8)
    rng = np.random.default_rng(3)
    grid = (rng.standard_normal((channels, 8, 8, 8)) * 0.4).astype(
        np.float32)
    jnet = JSRN.make(**dict(dict(layers="48:48", activation="SnakeAlt:2",
                                 num_fourier=6, output_mode="density",
                                 latent=JLatent(static_grid=grid), seed=3),
                            **spec))
    path = str(tmp_path / "w.npz")
    arrays = save_network(jnet, path)
    net = load_weights(path)
    got_arrays = dict(net.named_parameters())
    assert sorted(got_arrays) == sorted(arrays)
    for key, a in arrays.items():
        np.testing.assert_array_equal(got_arrays[key].detach().numpy(), a)
    assert net.output_mode == jnet.output_mode
    assert net.use_direction == bool(jnet.input.has_direction)
    pos = rng.uniform(-0.6, 0.6, (257, 3)).astype(np.float32)
    d = rng.standard_normal((257, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want, _ = JVolume.make(jnet).eval_density(jnp.asarray(pos),
                                              jnp.asarray(d))
    with torch.no_grad():
        got, _ = VolumeInterpolationNetwork(net).eval_density(
            torch.tensor(pos), torch.tensor(d))
    assert got.shape == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
