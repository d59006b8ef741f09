"""Port parity, the paper's wide networks (Table 1: hidden widths 32-128)
and layers of mixed widths on TPU kernel rows 1-7: the port's plain
versions (what every kernel is held to on the card) against the JAX
package in Pallas interpret mode, on the same numpy-seeded networks, at
16^2 rays, stepsize 1/32 and 64-ray tiles.

- The render of both engines (``mega_trace_dvr``, ``fused_trace_dvr``) on
  a 128:128:128 network and on mixed 64:32 and 48:96 networks: image atol
  1e-4.
- The differentiable pair of both engines on 128:128:128 and 96:96:
  image atol 1e-4, every gradient leaf atol 2e-5 / rtol 1e-3 (the
  contract of tests/test_fused.py).
- Mixed widths in training: the JAX package's adjoint raises, and so do
  the port's kernel checks of both engines; the port's plain march trains
  such a network (a deliberate difference, ROADMAP §C).
- Row 7's values on 1,024 positions, 128 wide and mixed: values atol
  2e-5, the inside mask equal; its position gradient on 1,024 interior
  positions of a 128:128:128 network: atol 2e-5 / rtol 1e-3.
- Normals and Phong shading of rows 1 and 4 on a 128:128:128 network
  against the JAX normals megakernel and segment engine: colour 2e-4,
  normal 5e-4, depth 1e-4 (tests/test_fused.py's gates).
- ``srn_from_arrays`` on those networks; ``kernel_width`` and the packing
  of both engines: every layer padded by its own shape to the instance
  of the widest, and the plain network on the packed, padded weights
  equal to the unpadded network.
- The plan mirror: every Table 1 shape (tests/test_fused.py's
  ``test_choose_fused_config_sweep``: widths 32, 48, 64, 96 and 128 at
  2, 4 and 6 layers) gets a forward plan on 256-ray tiles and a backward
  plan, within 227 KB; above 64 wide the hidden matrices take no shared
  memory (the wide plan).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.brdf import BRDFLambert as JBRDF
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.ops.fused_dvr import fused_trace_dvr as jfused
from fvsrn_tpu.ops.fused_eval import make_fused_eval as jmake
from fvsrn_tpu.ops.fused_mega import mega_trace_dvr as jmega
from fvsrn_tpu_torch.brdf import BRDFLambert
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.ops import fused_dvr, fused_mega, sample_mlp
from fvsrn_tpu_torch.ops.fused_dvr import (_network_values,
                                           fused_trace_dvr_plain,
                                           pack_segment_weights)
from fvsrn_tpu_torch.ops.fused_eval import make_fused_eval
from fvsrn_tpu_torch.ops.fused_mega import mega_trace_dvr_plain
from tests.test_torch_segment import BMIN, BSIZE, RAMP, rays16, t, tfs
from tests.test_torch_tf_modes import SEG, STEPS, TILE
from tests.test_torch_tf_modes_grad import both, check
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
H = 1 / 32
ENGINES = ("segment", "mega")
RENDER_NETS = ("128:128:128", "64:32", "48:96")
TRAIN_NETS = ("128:128:128", "96:96")
MIXED = ("64:32", "48:96")
TABLE1_WIDTHS = (32, 48, 64, 96, 128)
TABLE1_LAYERS = (2, 4, 6)


def jnet_of(layers, channels=8, seed=7, output_mode="density"):
    """A seeded JAX SRN of hidden ``layers`` (SnakeAlt:2, 6 Fourier
    features, a sigmoid density head, which keeps a random network's
    samples contributing; a (channels, 8, 8, 8) grid)."""
    rng = np.random.default_rng(seed)
    lat = JLatent()
    if channels:
        lat = JLatent(static_grid=(rng.standard_normal(
            (channels, 8, 8, 8)) * 0.3).astype(np.float32))
    return JSRN.make(layers=layers, activation="SnakeAlt:2", num_fourier=6,
                     output_mode=output_mode, latent=lat, seed=seed)


def port(jnet):
    return srn_from_arrays(*network_arrays(jnet))


def render(engine, march, net, rs, rd, tf, **kw):
    """``march`` (either package's, either engine's) at the tests' march
    settings; the port's megakernel takes no step bound."""
    kw = dict(stepsize=H, seg=SEG, tile=TILE, **kw)
    if engine != "mega" or march is jmega:
        kw["max_steps"] = STEPS
    return march(rs, rd, net, BMIN, BSIZE, tf, **kw)


@pytest.mark.parametrize("layers", RENDER_NETS)
@pytest.mark.parametrize("engine", ENGINES)
def test_render_matches_jax(engine, layers):
    """Rows 1 and 4: the plain march of a wide or mixed network against
    the JAX kernels, which take both."""
    jnet = jnet_of(layers)
    jtf, tf = tfs(RAMP)
    rs, rd = rays16()
    jm = jmega if engine == "mega" else jfused
    want = np.asarray(render(engine, jm, jnet, rs, rd, jtf.tensor,
                             table_dtype=jnp.float32, interpret=True))
    pm = mega_trace_dvr_plain if engine == "mega" else fused_trace_dvr_plain
    got = render(engine, pm, port(jnet), t(rs), t(rd), tf.tensor,
                 table_dtype=torch.float32)
    assert want[:, 3].max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("layers", TRAIN_NETS)
@pytest.mark.parametrize("engine", ENGINES)
def test_training_matches_jax(engine, layers):
    """Rows 2-3 and 5-6: the plain differentiable pair of a wide network
    (the texture TF) against the JAX custom VJPs: image and every leaf."""
    check(*both(engine, "texture", jnet_of(layers)))


def _rays256():
    """A 256-ray packet (the kernels' tile): zeros, the checks read its
    shape only."""
    return torch.zeros(256, 8)


@pytest.mark.parametrize("layers", MIXED)
@pytest.mark.parametrize("engine", ENGINES)
def test_mixed_widths_train_by_the_plain_march_only(engine, layers):
    """Layers of several widths: JAX's adjoint raises (its segment
    adjoint takes one hidden width) and the port's kernel checks refuse
    training while they take the render; the port's plain march trains
    the network (every leaf finite, the layers' nonzero)."""
    jnet = jnet_of(layers)
    jtf, tf = tfs(RAMP)
    rs, rd = rays16()
    jm = jmega if engine == "mega" else jfused
    kw = dict(table_dtype=jnp.float32) if engine == "mega" else {}

    def jloss(net):
        return jnp.sum(render(engine, jm, net, rs, rd, jtf.tensor,
                              differentiable=True, interpret=True, **kw))

    with pytest.raises(TypeError):
        jax.grad(jloss)(jnet)
    net = port(jnet)
    if engine == "mega":
        fused_mega._check_kernel_inputs(net, _rays256(), 256)
        with pytest.raises(NotImplementedError, match="several widths"):
            fused_mega._check_kernel_inputs(net, _rays256(), 256,
                                            differentiable=True)
    else:
        fused_dvr._check_kernel_inputs(net, tf.tensor)
        with pytest.raises(NotImplementedError, match="several widths"):
            fused_dvr._check_kernel_inputs(net, tf.tensor,
                                           differentiable=True)
    pm = mega_trace_dvr_plain if engine == "mega" else fused_trace_dvr_plain
    img = render(engine, pm, net, t(rs), t(rd), tf.tensor,
                 differentiable=True)
    img.sum().backward()
    for name, p in net.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name
        if name.startswith("layers."):
            assert float(p.grad.abs().max()) > 0, name


@pytest.mark.parametrize("layers", RENDER_NETS)
def test_fused_eval_matches_jax(layers):
    """Row 7's values at 1,024 positions (20% past each face): the JAX
    evaluator takes wide and mixed networks, so does the port."""
    jnet = jnet_of(layers, seed=5)
    pos = (np.random.default_rng(3).random((1024, 3)) * 1.4 - 0.7).astype(
        np.float32)
    box = (BMIN, BSIZE)
    v, inside = make_fused_eval(port(jnet), *box)(torch.from_numpy(pos))
    jv, jin = jmake(jnet, *box, tile=128, interpret=True)(jnp.asarray(pos))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(jin))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=2e-5)


def test_fused_eval_gradient_128_matches_jax():
    """Row 7's gradient instance at width 128: values and the world
    position gradient at 1,024 interior positions against the JAX
    evaluator's gradient."""
    jnet = jnet_of("128:128:128", seed=5)
    pos = (np.random.default_rng(4).random((1024, 3)) * 0.9 - 0.45).astype(
        np.float32)
    box = (BMIN, BSIZE)
    v, _, g = make_fused_eval(port(jnet), *box, want_grad=True)(
        torch.from_numpy(pos))
    jv, _, jg = jmake(jnet, *box, tile=128, want_grad=True,
                      interpret=True)(jnp.asarray(pos))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-5,
                               rtol=1e-3)
    assert float(g.abs().max()) > 0.05


# the JAX tests' BRDF (tests/test_fused.py:345)
PHONG = dict(enable_phong=True, ambient=0.2, specular=0.3,
             magnitude_center=0.02, magnitude_radius=0.02,
             light=(0.3, -0.5, -1.0))


@pytest.mark.parametrize("engine", ENGINES)
def test_normals_128_match_jax(engine):
    """Rows 1 and 4 with normals and Phong shading on 128:128:128: the
    plain march against the JAX kernels (the normals megakernel, the
    segment engine's normals march), colour, normal and depth."""
    jnet = jnet_of("128:128:128")
    jtf, tf = tfs(RAMP)
    rs, rd = rays16()
    jm = jmega if engine == "mega" else jfused
    kw = dict(need_normals=True, enable_early_out=False)
    jkw = dict(table_dtype=jnp.float32) if engine == "mega" else {}
    want = render(engine, jm, jnet, rs, rd, jtf.tensor,
                  brdf=JBRDF.make(**PHONG), interpret=True, **kw, **jkw)
    pm = mega_trace_dvr_plain if engine == "mega" else fused_trace_dvr_plain
    got = render(engine, pm, port(jnet), t(rs), t(rd), tf.tensor,
                 brdf=BRDFLambert.make(**PHONG), table_dtype=torch.float32,
                 **kw)
    for field, tol in (("color", 2e-4), ("normal", 5e-4), ("depth", 1e-4)):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=0, atol=tol, err_msg=field)
    assert np.abs(np.asarray(want.normal)).max() > 0.1
    assert np.asarray(want.color)[:, 3].max() > 0.1


@pytest.mark.parametrize("layers", RENDER_NETS + ("96:96",))
def test_srn_from_arrays(layers):
    """The converter keeps every layer's shape and values, and the
    network's hidden widths are the layers'."""
    arrays, meta = network_arrays(jnet_of(layers))
    net = srn_from_arrays(arrays, meta)
    widths = [int(w) for w in layers.split(":")]
    assert fused_mega._hidden_widths(net) == widths
    params = dict(net.named_parameters())
    for key, a in arrays.items():
        np.testing.assert_array_equal(params[key].detach().numpy(),
                                      np.asarray(a, np.float32), err_msg=key)


@pytest.mark.parametrize("layers,width,mixed", [
    ("32:32:32", 32, False), ("20:20", 32, False), ("64:32", 64, True),
    ("48:96", 128, True), ("96:96", 128, False), ("100:72", 128, True),
    ("128:128:128", 128, False)])
def test_kernel_width(layers, width, mixed):
    """Every layer pads to the instance of the widest: 32, 48, 64 or
    128; wider than 128 raises."""
    net = port(jnet_of(layers, channels=0))
    assert fused_mega.kernel_width(net) == width
    assert fused_mega.mixed_widths(net) == mixed
    with pytest.raises(NotImplementedError, match="up to 128"):
        fused_mega.kernel_width(port(jnet_of("64:160", channels=0)))


def _positions(n=200):
    x = np.random.default_rng(9).random((n, 3)).astype(np.float32)
    return torch.from_numpy(x)


def _values(params, x01):
    return _network_values(params, x01, None, direction=False,
                           activation=("SnakeAlt", 2.0),
                           output_mode="density")


@pytest.mark.parametrize("layers", ("64:32", "48:96", "100:72",
                                    "128:128:128"))
def test_mega_packing_pads_each_layer(layers):
    """The megakernel's packed weights: each layer zero-padded by its own
    shape to the widest's instance, and the network on the padded layers
    read back from the packing equals the unpadded network."""
    net = port(jnet_of(layers))
    tf = torch.tensor(np.asarray(tfs(RAMP)[0].tensor))
    params = fused_mega._params(net, tf)
    spec = fused_mega._spec(net, BMIN, BSIZE, stepsize=H, seg=32, tile=256,
                            density_min=0.0, density_max=1.0,
                            enable_early_out=True)
    hp = fused_mega.kernel_width(net)
    assert spec.width == max(fused_mega._hidden_widths(net))
    packed = fused_mega._pack_weights(params, spec)
    nf, k_in = params[1].shape[0], params[3].shape[1]
    nh = len(net.layers) - 2
    k1 = 3 + 2 * nf + fused_mega.LATENT_CHANNELS
    sizes = [3 * nf, hp * k1, hp, nh * hp * hp, nh * hp, hp, 1, tf.numel()]
    b, w1, b1, wh, bh, wo, bo, tfp = packed.split(sizes)
    torch.testing.assert_close(tfp.reshape(tf.shape), tf)
    padded = [tf, params[1], params[2],
              w1.reshape(hp, k1)[:, :k_in], b1]
    wh, bh = wh.reshape(nh, hp, hp), bh.reshape(nh, hp)
    for i in range(nh):
        w = params[5 + 2 * i]
        assert not wh[i][w.shape[0]:].any() and not wh[i][:, w.shape[1]:].any()
        padded += [wh[i], bh[i]]
    padded += [wo.reshape(1, hp), bo]
    x01 = _positions()
    torch.testing.assert_close(_values(padded, x01), _values(params, x01),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("layers", ("64:32", "48:96", "128:128:128"))
def test_segment_packing_pads_each_layer(layers):
    """The per-segment engine's packed weights (input-major): as the
    megakernel's, each layer padded by its own shape."""
    net = port(jnet_of(layers))
    tf = torch.tensor(np.asarray(tfs(RAMP)[0].tensor))
    params = fused_mega._params(net, tf)
    hp = fused_mega.kernel_width(net)
    packed = pack_segment_weights(net, tf)
    nf, k_in = params[1].shape[0], params[3].shape[1]
    n_lat = k_in - 3 - 2 * nf
    nh = len(net.layers) - 2
    k1 = 6 + 2 * nf + 16 * fused_dvr._latent_chunks(net)
    sizes = [k1 * hp, hp, nh * hp * hp, nh * hp, 4 * hp, 4, 3 * nf, 3 * nf,
             tf.numel()]
    w1, b1, wh, bh, wo, bo, _, _, _ = packed.split(sizes)
    w1 = w1.reshape(k1, hp)
    padded = [tf, params[1], params[2],
              torch.cat([w1[:3], w1[6:6 + 2 * nf + n_lat]]).T, b1]
    wh, bh = wh.reshape(nh, hp, hp), bh.reshape(nh, hp)
    for i in range(nh):
        padded += [wh[i].T, bh[i]]
    padded += [wo.reshape(4, hp)[:1], bo[:1]]
    x01 = _positions()
    torch.testing.assert_close(_values(padded, x01), _values(params, x01),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_layers", TABLE1_LAYERS)
@pytest.mark.parametrize("width", TABLE1_WIDTHS)
def test_table1_shapes_have_plans(width, n_layers):
    """The flagship's inputs (14 Fourier features, a 16-channel grid, 16
    knots; the texture TF's 256 texels in the TF modes) at every Table 1
    shape: a forward plan of eight warps (256-ray tiles) and a backward
    plan, piecewise and in the TF modes, within 227 KB; above 64 wide the
    wide plans, whose hidden matrices take no shared memory."""
    net = port(JSRN.make(layers=":".join([str(width)] * n_layers),
                         num_fourier=14, seed=1))
    hp = fused_mega.kernel_width(net)
    nh = n_layers - 1
    fwd = sample_mlp.check_fwd_plan("t", hp, 14, 1, nh, 16, warps=8)
    assert fwd.bytes <= sample_mlp.SMEM_LIMIT and fwd.warps == 8
    for tf_floats, state in ((None, False), (1024, True)):
        bwd = sample_mlp.check_plan("t", hp, 3 + 28 + 16, nh, 14, 16,
                                    tf_floats, state)
        assert bwd.bytes <= sample_mlp.SMEM_LIMIT
        assert bwd.wide == (hp > 64)
        assert (bwd.regions["Wh"] == 0) == (hp > 64 or nh == 0)
    assert fwd.wide == (hp > 64)
    assert (fwd.regions["Wh"] == 0) == (hp > 64 or nh == 0)
    rays = torch.zeros(256, 8)
    fused_mega._check_kernel_inputs(net, rays, 256, differentiable=True)
