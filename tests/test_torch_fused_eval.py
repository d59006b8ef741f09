"""Port parity, the fused sample evaluator (TPU kernel row 7): the port's
``make_fused_eval`` (its plain version here, on the CPU) against the JAX
``make_fused_eval`` in Pallas interpret mode on the same seeded network
and positions (20% of the box's width spilled past each face): values
atol 2e-5 and the inside mask equal (tests/test_fused_eval.py's
contract), the position gradient on interior positions atol 5e-4 / rtol
1e-3, and the same refusals. The CUDA kernel is held against the plain
version on the card by tests/test_torch_kernels.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import VolumeInterpolationNetwork as JVol
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.ops.fused_eval import make_fused_eval as jmake
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.ops import fused_eval
from fvsrn_tpu_torch.ops.fused_eval import make_fused_eval
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
BOX = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))


def nets(channels=8, output_mode="density", direction=False, seed=11):
    """The same seeded SRN in both packages (32:32, SnakeAlt:2, 6 Fourier
    features, a (channels, 8, 8, 8) grid)."""
    rng = np.random.default_rng(seed)
    latent = JLatent()
    if channels:
        latent = JLatent(static_grid=jnp.asarray(
            (rng.standard_normal((channels, 8, 8, 8)) * 0.3)
            .astype(np.float32)))
    jnet = JSRN.make(layers="32:32", activation="SnakeAlt:2", num_fourier=6,
                     output_mode=output_mode, latent=latent, seed=seed,
                     use_direction=direction)
    return jnet, srn_from_arrays(*network_arrays(jnet))


def positions(n, seed=0, spill=0.2):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)).astype(np.float32) * (1 + 2 * spill)
            - (0.5 + spill))


@pytest.mark.parametrize("output_mode", ["density", "density:direct"])
@pytest.mark.parametrize("channels", [0, 8])
def test_fused_eval_matches_jax(channels, output_mode):
    jnet, net = nets(channels, output_mode)
    pos = positions(500)
    before = fused_eval.SAMPLE_EVAL_LAUNCHES
    v, inside = make_fused_eval(net, *BOX)(torch.from_numpy(pos))
    assert fused_eval.SAMPLE_EVAL_LAUNCHES == before   # the plain version
    jv, jin = jmake(jnet, *BOX, tile=128, interpret=True)(jnp.asarray(pos))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(jin))
    assert not inside.all() and inside.any()
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=2e-5)


def test_fused_eval_direction_matches_jax():
    jnet, net = nets(8, direction=True)
    pos = positions(300, seed=3)
    d = np.random.default_rng(4).standard_normal((300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v, _ = make_fused_eval(net, *BOX)(torch.from_numpy(pos),
                                      torch.from_numpy(d))
    jv, _ = jmake(jnet, *BOX, tile=128, interpret=True)(jnp.asarray(pos),
                                                        jnp.asarray(d))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=2e-5)
    # with direction=None the direction is zero
    v0, _ = make_fused_eval(net, *BOX)(torch.from_numpy(pos))
    jv0, _ = jmake(jnet, *BOX, tile=128, interpret=True)(jnp.asarray(pos))
    np.testing.assert_allclose(v0.numpy(), np.asarray(jv0), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("output_mode", ["density", "density:direct"])
def test_fused_eval_gradient_matches_jax(output_mode):
    """want_grad on interior positions: the world-position gradient, the
    clip's gradient zero where the density is clipped."""
    jnet, net = nets(8, output_mode, seed=17)
    pos = (np.random.default_rng(5).random((256, 3)) * 0.9 - 0.45).astype(
        np.float32)
    v, _, g = make_fused_eval(net, *BOX, want_grad=True)(
        torch.from_numpy(pos).reshape(16, 16, 3))
    assert g.shape == (16, 16, 3)
    jv, _, jg = jmake(jnet, *BOX, tile=128, want_grad=True,
                      interpret=True)(jnp.asarray(pos))
    np.testing.assert_allclose(v.reshape(-1).numpy(), np.asarray(jv),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(g.reshape(-1, 3).numpy(), np.asarray(jg),
                               atol=5e-4, rtol=1e-3)
    assert float(g.abs().max()) > 0.1
    # the kernel's plain version against autograd through the volume
    want = JVol.make(jnet).eval_normal(jnp.asarray(pos))
    np.testing.assert_allclose(g.reshape(-1, 3).numpy(), np.asarray(want),
                               atol=5e-4, rtol=1e-3)


def test_fused_eval_bf16_table_matches_jax():
    jnet, net = nets(8)
    pos = positions(256, seed=9)
    v, _ = make_fused_eval(net, *BOX, table_dtype=torch.bfloat16)(
        torch.from_numpy(pos))
    jv, _ = jmake(jnet, *BOX, tile=128, table_dtype=jnp.bfloat16,
                  interpret=True)(jnp.asarray(pos))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=2e-5)


@pytest.mark.parametrize("case", ["rgbo", "grid24"])
def test_fused_eval_refuses_as_jax(case):
    """An rgbo head (NotImplementedError) and a 24-channel grid (the
    neighborhood table's AssertionError) raise as in the JAX package."""
    kw = (dict(output_mode="rgbo") if case == "rgbo"
          else dict(channels=24))
    jnet, net = nets(**kw)
    with pytest.raises(Exception) as want:
        jmake(jnet, *BOX, tile=128, interpret=True)
    with pytest.raises(want.type):
        make_fused_eval(net, *BOX)
    assert want.type is (NotImplementedError if case == "rgbo"
                         else AssertionError)
