"""The flagship's weights as the port reads them: the committed ``.npz``
export equals the JAX checkpoint's leaves exactly, and
``convert.srn_from_arrays`` rebuilds every layer from it."""
import jax
import numpy as np
import pytest

from fvsrn_tpu.scenes import dense_scene as jdense_scene
from fvsrn_tpu.train.checkpoints import RunCheckpoint
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.scenes import dense_scene
from fvsrn_tpu_torch.train.checkpoints import load_arrays, load_weights
from tools.export_torch_weights import _key_name, export


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


def test_srn_from_arrays_rejects_unported_leaves():
    arrays, meta = load_arrays(dense_scene()[2])
    arrays["latent.time_grid"] = np.zeros((2, 4, 4, 4, 4), np.float32)
    with pytest.raises(NotImplementedError):
        srn_from_arrays(arrays, meta)
