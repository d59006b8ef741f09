"""Port parity, fused march over the networks the JAX megakernel takes
beyond the flagship's shape: hidden widths 20 (zero-padded to 32 in the
kernels), 48 and 64, every activation, the rgbo heads and direction
input (the paper's network, activation and density-vs-color sweeps).

- the plain version (``mega_trace_dvr_plain``) against the JAX
  ``mega_trace_dvr`` in Pallas interpret mode with its bf16 latent table,
  atol 1e-4 (16x16, 64-ray tiles, 16-point segments, as
  tests/test_torch_mega.py);
- the plain differentiable march against the JAX custom VJP, at the
  tolerances of tests/test_torch_mega_grad.py (image atol 1e-4, loss
  rtol 1e-5, every leaf atol 2e-5 / rtol 1e-3);
- the FUSED product render (route "mega") of an rgbo network and of a
  48-wide Sine network against the JAX package's, atol 1e-4.

Sine:30 is held to the JAX package's float32 lattice oracle
(``trace_dvr(lattice=True)``, no tile vote) and its autograd instead of
the JAX megakernel: that kernel evaluates the sine by a degree-9
polynomial (max error 5.9e-6, ``fvsrn_tpu/ops/fused_dvr.py:_SINP``),
which the 30x pre-activations carry to 2.9e-3 in the image against its
own oracle here, while the port computes float32 sines (5.4e-5 off the
oracle); the test asserts the JAX kernel's distance, so that it shows
why. Its gradients are ill-conditioned in float32 whatever computes
them: a seeded relative 1e-7 noise in the weights (one ulp) moves the
plain version's own leaves by 0.4-4.7% (tools/port_conditioning.py
prints these figures). Each Sine:30 leaf is held to
``SINE_FLIP`` times the plain version's own change under that noise
(1e-3 at least). Sine:3's gradients are held to the oracle's autograd
at the JAX custom VJP's tolerances (the polynomial moves the JAX
kernel's loss by 1.4e-5 relative there, over their 1e-5).

The CUDA kernels are held against the plain version on the card by
tests/test_torch_kernels.py and chip_smoke.py phase O."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.inference import LoadedModel as JLoadedModel
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.models.srn import SceneRepresentationNetwork as JSRN
from fvsrn_tpu.ops.fused_dvr import block_ray_permutation as jblock_perm
from fvsrn_tpu.ops.fused_mega import mega_trace_dvr as jmega
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import max_steps_bound
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace_dvr
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu_torch.camera import CameraOnASphere
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.inference import LoadedModel
from fvsrn_tpu_torch.ops.fused_mega import mega_trace_dvr_plain
from fvsrn_tpu_torch.raytracer.dvr import RayEvaluationSteppingDvr
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from tools.export_torch_weights import network_arrays

torch.set_num_threads(1)
H = 1 / 64
SEG, TILE = 16, 64
BMIN, BSIZE = (-0.5, -0.5, -0.5), (1.0, 1.0, 1.0)
TF = dict(rgb=[[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9]],
          opacity=[2.0, 10.0, 30.0], positions=[0.0, 0.45, 1.0])

# name -> JSRN.make options (a 4-channel 8^3 grid, 6 Fourier features,
# seed 7). The sigmoid ``density`` head keeps a random network's samples
# contributing where ``density:direct`` would clip most of them to 0.
NETWORKS = {
    "width20": dict(layers="20:20:20"),
    "width48": dict(layers="48:48:48"),
    "width64": dict(layers="64:64"),
    "relu": dict(activation="ReLU"),
    "sine30": dict(activation="Sine:30"),
    "sine3": dict(activation="Sine:3"),
    "snake1": dict(activation="Snake:1"),
    "sigmoid": dict(activation="Sigmoid"),
    "softplus": dict(activation="Softplus"),
    "rgbo": dict(output_mode="rgbo"),
    "rgbo_exp": dict(output_mode="rgbo:exp"),
    "rgbo_direct": dict(output_mode="rgbo:direct"),
    "direction": dict(use_direction=True, disable_direction_in_fourier=False),
}


def jax_net(name, grid=True):
    rng = np.random.default_rng(7)
    lat = JLatent(static_grid=(rng.standard_normal((4, 8, 8, 8)) * 0.3)
                  .astype(np.float32) if grid else None)
    kw = dict(layers="32:32:32", activation="SnakeAlt:2", num_fourier=6,
              output_mode="density", latent=lat, seed=7)
    kw.update(NETWORKS[name])
    return JSRN.make(**kw)


def block_rays(distance=1.6, width=16):
    """Rays of a width^2 view in 8x8 pixel blocks (tiles of 64 rays)."""
    rs, rd = jgenerate_rays(JCam.make(pitch=0.3, yaw=0.8, distance=distance),
                            width, width)
    perm, _ = jblock_perm(width, width, 8, 8)
    return (np.asarray(rs).reshape(-1, 3)[perm],
            np.asarray(rd).reshape(-1, 3)[perm])


# held to the JAX package's float32 oracle (see the module doc): the
# forward of Sine:30, the gradients of both Sine networks
ORACLE = {"sine30"}
ORACLE_GRAD = {"sine3", "sine30"}
SINE_NOISE = 1e-7    # relative weight noise: one float32 ulp
SINE_FLIP = 5.0      # a leaf's bound, in units of its change under it


def jax_oracle(jnet, rs, rd, tf_tensor):
    """The JAX package's float32 lattice march (no early-out) of the rays,
    rgba (R, 4)."""
    jtf = JTF(tensor=tf_tensor)
    return jtrace_dvr(jnp.asarray(rs), jnp.asarray(rd), JVolume.make(jnet),
                      jtf, JCfg.make(stepsize=H, enable_early_out=False),
                      max_steps_bound(BSIZE, H), lattice=True).color


def jax_mega(jnet, rs, rd, tf_tensor, **kw):
    return jmega(jnp.asarray(rs), jnp.asarray(rd), jnet, BMIN, BSIZE,
                 tf_tensor, stepsize=H, max_steps=max_steps_bound(BSIZE, H),
                 seg=SEG, tile=TILE, interpret=True, **kw)


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_mega_plain_matches_jax_networks(name):
    """The render: bf16 table, the tile vote on (Sine:30: float32 table,
    no vote, against the oracle)."""
    jnet = jax_net(name)
    net = srn_from_arrays(*network_arrays(jnet))
    rs, rd = block_rays()
    jtf = JTF.make(**TF)
    kw = dict(stepsize=H, seg=SEG, tile=TILE)
    if name in ORACLE:
        want = np.asarray(jax_oracle(jnet, rs, rd, jtf.tensor))
        kernel = np.asarray(jax_mega(jnet, rs, rd, jtf.tensor,
                                     table_dtype=jnp.float32,
                                     enable_early_out=False))
        assert np.abs(kernel - want).max() > 1e-3
        kw.update(table_dtype=torch.float32, enable_early_out=False)
    else:
        want = np.asarray(jax_mega(jnet, rs, rd, jtf.tensor,
                                   table_dtype=jnp.bfloat16))
    got = mega_trace_dvr_plain(
        torch.tensor(rs), torch.tensor(rd), net, BMIN, BSIZE,
        TransferFunctionPiecewiseLinear.make(**TF).tensor, **kw).numpy()
    assert want[:, 3].max() > 0.2
    np.testing.assert_allclose(got, want, atol=1e-4)


def port_grads(net, rs, rd, w, tf_tensor, early_out=True):
    """(loss, image, grads) of sum(w * rgba) through the port's plain
    differentiable march; grads keyed by leaf name, the TF as "tf"."""
    tf = torch.tensor(np.asarray(tf_tensor), requires_grad=True)
    img = mega_trace_dvr_plain(torch.tensor(rs), torch.tensor(rd), net, BMIN,
                               BSIZE, tf, stepsize=H, seg=SEG, tile=TILE,
                               differentiable=True,
                               enable_early_out=early_out)
    loss = (img * torch.tensor(w)).sum()
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    grads["tf"] = tf.grad.numpy()
    return float(loss.detach()), img.detach().numpy(), grads


def grads_both(jnet, rs, rd, oracle=False):
    """(JAX (loss, image, grads), port (loss, image, grads)) of loss =
    sum(w * rgba) through the differentiable march, float32 table, the
    tile vote on; with ``oracle`` the JAX side is autograd through its
    float32 lattice oracle and neither side votes. Grads keyed by leaf
    name, the TF as "tf"."""
    w = np.random.default_rng(11).uniform(-1, 1, (rs.shape[0], 4)).astype(
        np.float32)
    jtf = JTF.make(**TF)

    def jloss(net, tf_tensor):
        if oracle:
            img = jax_oracle(net, rs, rd, tf_tensor)
        else:
            img = jax_mega(net, rs, rd, tf_tensor, differentiable=True,
                           table_dtype=jnp.float32)
        return jnp.sum(img * w), img

    (jl, jimg), (gnet, gtf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnet, jnp.asarray(jtf.tensor))
    jgrads, _ = network_arrays(gnet)
    jgrads["tf"] = np.asarray(gtf)
    net = srn_from_arrays(*network_arrays(jnet))
    return ((float(jl), np.asarray(jimg), jgrads),
            port_grads(net, rs, rd, w, jtf.tensor, early_out=not oracle))


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("name", ["width48", "sine3", "sine30", "rgbo",
                                  "direction"])
def test_mega_grad_matches_jax_networks(name):
    """Every gradient leaf of the differentiable march; an rgbo head
    reads no TF, so the TF's gradient is zero in both packages. Sine:30
    against the oracle, each leaf within its float32 conditioning (see
    the module doc)."""
    jnet = jax_net(name)
    rs, rd = block_rays()
    (jl, jimg, jgrads), (loss, img, grads) = grads_both(
        jnet, rs, rd, oracle=name in ORACLE_GRAD)
    np.testing.assert_allclose(img, jimg, atol=1e-4)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    if name in ORACLE:
        arrays, meta = network_arrays(jnet)
        noise = np.random.default_rng(3)
        noisy = {k: (v * (1.0 + SINE_NOISE * noise.standard_normal(v.shape))
                     ).astype(np.float32) for k, v in arrays.items()}
        w = np.random.default_rng(11).uniform(-1, 1, (rs.shape[0], 4))
        _, _, moved = port_grads(srn_from_arrays(noisy, meta), rs, rd,
                                 w.astype(np.float32),
                                 JTF.make(**TF).tensor, early_out=False)
        for leaf in jgrads:
            own = rel(moved[leaf], grads[leaf])
            assert own > 1e-3, leaf      # ill-conditioned: see the doc
            assert rel(grads[leaf], jgrads[leaf]) <= SINE_FLIP * own, leaf
        return
    for leaf in jgrads:
        if leaf == "tf" and name == "rgbo":
            assert not np.abs(jgrads[leaf]).any()
            assert not np.abs(grads[leaf]).any()
            continue
        assert np.abs(jgrads[leaf]).max() > 0, leaf
        np.testing.assert_allclose(grads[leaf], jgrads[leaf], atol=2e-5,
                                   rtol=1e-3, err_msg=leaf)


@pytest.mark.parametrize("name", ["rgbo", "sine48"])
def test_fused_render_matches_jax_networks(name):
    """The product render's route 1 (the megakernel) of an rgbo network
    and of a 48-wide Sine network, 32x32 at 1/128, against the JAX
    package's FUSED render."""
    kw = dict(num_fourier=6, output_mode="density", seed=7)
    kw.update(dict(output_mode="rgbo") if name == "rgbo"
              else dict(layers="48:48:48", activation="Sine:3"))
    rng = np.random.default_rng(7)
    lat = JLatent(static_grid=(rng.standard_normal((8, 8, 8, 8)) * 0.3)
                  .astype(np.float32))
    jnet = JSRN.make(latent=lat, **kw)
    h, width = 1 / 128, 32
    cam = dict(pitch=0.3, yaw=0.5, distance=1.6)
    jm = JLoadedModel(jnet, JTF.make(**TF), config=JCfg.make(stepsize=h))
    m = LoadedModel(srn_from_arrays(*network_arrays(jnet)),
                    TransferFunctionPiecewiseLinear.make(**TF),
                    config=RayEvaluationSteppingDvr.make(stepsize=h))
    render = m.prepare_network_render(CameraOnASphere.make(**cam), width,
                                      width, "FUSED", device="cpu")
    assert render.route == "mega"
    got = render().numpy()
    want = np.asarray(jm.render_network(JCam.make(**cam), width, width,
                                        "FUSED", interpret=True))
    assert want[..., 3].max() > 0.2
    np.testing.assert_allclose(got, want, atol=1e-4)
