"""Port parity, the SRN variants (``fvsrn_tpu_torch/models/variants.py``
against ``fvsrn_tpu/models/variants.py``): ``make`` with the JAX seeds
gives the JAX weights bit for bit, and so does the converter; the forward
on 64 positions is within 1e-5 (absolute) across ensembles and times, in
both evaluation modes; the weights' gradients of a coherent loss are
within 1e-4 relative (per leaf, in norm); the plain ``trace_dvr`` of a
``VolumeInterpolationNetwork`` over each network at 32x32, stepsize 1/64,
is within 1e-5 of the JAX march; a FUSED render and a fused screen step
of each raise; and the JAX package's own tests (tests/test_meta.py:
training shrinks the loss, outputs differ by ensemble) on the port.

The JAX package's ``VolumeInterpolationNetwork`` reads the network's
``use_direction``, which its variant and meta networks do not have (their
own volume raises ``AttributeError``); the port's networks have it
(False). The march's comparison gives the JAX classes the same attribute
for the test only (``monkeypatch``)."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.camera import CameraOnASphere as JCam
from fvsrn_tpu.camera import generate_rays as jgenerate_rays
from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.network_volume import \
    VolumeInterpolationNetwork as JVolume
from fvsrn_tpu.models.variants import ModulatedSineNetwork as JModSine
from fvsrn_tpu.models.variants import ResidualSineNetwork as JResSine
from fvsrn_tpu.raytracer.dvr import RayEvaluationSteppingDvr as JCfg
from fvsrn_tpu.raytracer.dvr import max_steps_bound as jmax_steps
from fvsrn_tpu.raytracer.dvr import trace_dvr as jtrace
from fvsrn_tpu.transfer import TransferFunctionPiecewiseLinear as JTF
from fvsrn_tpu.volume.implicit import VolumeInterpolationImplicit as JImpl
from fvsrn_tpu_torch.camera import CameraOnASphere
from fvsrn_tpu_torch.convert import (modulated_sine_from_arrays,
                                     residual_sine_from_arrays)
from fvsrn_tpu_torch.inference import LoadedModel
from fvsrn_tpu_torch.models.latent import LatentSpace
from fvsrn_tpu_torch.models.network_volume import VolumeInterpolationNetwork
from fvsrn_tpu_torch.models.variants import (ModulatedSineNetwork,
                                             ResidualSineNetwork)
from fvsrn_tpu_torch.ops import fused_dvr, fused_mega
from fvsrn_tpu_torch.raytracer.dvr import (RayEvaluationSteppingDvr,
                                           trace_dvr)
from fvsrn_tpu_torch.train.optimizer import make_optimizer
from fvsrn_tpu_torch.train.screen import fused_screen_supported
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear
from tools.export_torch_weights import _key_name

torch.set_num_threads(1)
FWD_TOL = 1e-5
GRAD_RTOL = 1e-4
MARCH_TOL = 1e-5
H = 1 / 64
TF = dict(rgb=[[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9]],
          opacity=[2.0, 10.0, 30.0], positions=[0.0, 0.45, 1.0])
# (time, ensemble) pairs: keyframes, between them, past the ends
CONDITIONS = [(0.0, 0.0), (1.5, 0.25), (3.7, 2.0), (9.0, -1.0)]


def jax_arrays(jnet) -> dict:
    """Every array leaf of a JAX network by its pytree path."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(jnet)
    return {_key_name(p): np.array(v, np.float32) for p, v in leaves}


_RENAMES = [(r"^(first|out)\.weight$", r"\1_w"),
            (r"^(first|out)\.bias$", r"\1_b"),
            (r"^blocks\.(\d+)\.w1$", r"blocks.\1.0"),
            (r"^blocks\.(\d+)\.b1$", r"blocks.\1.1"),
            (r"^blocks\.(\d+)\.w2$", r"blocks.\1.2"),
            (r"^blocks\.(\d+)\.b2$", r"blocks.\1.3"),
            (r"^(syn|mod)_layers\.(\d+)\.weight$", r"\1_layers.\2.0"),
            (r"^(syn|mod)_layers\.(\d+)\.bias$", r"\1_layers.\2.1")]


def jax_key(name: str) -> str:
    """The JAX pytree path of a port parameter's name."""
    for pat, rep in _RENAMES:
        name = re.sub(pat, rep, name)
    return name


def port_arrays(net) -> dict:
    return {jax_key(n): p.detach().numpy() for n, p in net.named_parameters()}


def latents(rng):
    """(JAX, port) latent spaces: a 4-channel ensemble vector over 3
    members and a 3-channel time vector over 5 keyframes."""
    ens = rng.random((1, 4, 3)).astype(np.float32)
    tim = rng.standard_normal((1, 3, 5)).astype(np.float32)
    return (JLatent(ensemble_vector=jnp.asarray(ens),
                    time_vector=jnp.asarray(tim)),
            LatentSpace(ensemble_vector=torch.from_numpy(ens),
                        time_vector=torch.from_numpy(tim)))


# name -> (JAX make, port make, make's options, {option: (JAX value, port
# value)})
def cases(rng):
    jlat, lat = latents(rng)
    return {
        "residual": (JResSine.make, ResidualSineNetwork.make,
                     dict(hidden=16, num_blocks=3, seed=4), {}),
        "residual_fourier_rgbo": (
            JResSine.make, ResidualSineNetwork.make,
            dict(hidden=24, num_blocks=2, num_fourier=4, omega0=10.0,
                 output_mode="rgbo", seed=5), {}),
        "modulated": (JModSine.make, ModulatedSineNetwork.make,
                      dict(hidden=16, num_layers=2, seed=5),
                      dict(latent=(jlat, lat))),
        "modulated_fourier": (
            JModSine.make, ModulatedSineNetwork.make,
            dict(hidden=32, num_layers=3, num_fourier=6,
                 output_mode="density:direct", seed=6),
            dict(latent=(jlat, lat))),
    }


def build(name, rng):
    jmake, pmake, kw, extra = cases(rng)[name]
    jkw, pkw = dict(kw), dict(kw)
    for k, (jv, pv) in extra.items():
        jkw[k], pkw[k] = jv, pv
    return jmake(**jkw), pmake(**pkw)


def convert(jnet):
    """The port's network from a JAX variant's arrays (``convert.py``)."""
    arrays = jax_arrays(jnet)
    if isinstance(jnet, JResSine):
        return residual_sine_from_arrays(arrays, {
            "block_weights": jnet.block_weights, "omega0": jnet.omega0,
            "output_mode": jnet.output_mode})
    return modulated_sine_from_arrays(arrays, {
        "num_layers": len(jnet.syn_layers), "w0": jnet.w0,
        "output_mode": jnet.output_mode})


NAMES = ["residual", "residual_fourier_rgbo", "modulated",
         "modulated_fourier"]


@pytest.mark.parametrize("name", NAMES)
def test_make_matches_jax_bit_for_bit(name, rng):
    jnet, net = build(name, rng)
    want = jax_arrays(jnet)
    for got in (port_arrays(net), port_arrays(convert(jnet))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


def forward_pair(jnet, net, x, t, e, mode):
    n = x.shape[0]
    want = np.asarray(jnet(jnp.asarray(x), time=jnp.full((n,), t),
                           ensemble=jnp.full((n,), e), mode=mode))
    got = net(torch.from_numpy(x), time=torch.full((n,), t),
              ensemble=torch.full((n,), e), mode=mode)
    return got, want


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, rng):
    jnet, net = build(name, rng)
    x = rng.random((64, 3)).astype(np.float32)
    outs = []
    for t, e in CONDITIONS:
        for mode in ("screen", "world"):
            got, want = forward_pair(jnet, net, x, t, e, mode)
            assert got.shape == want.shape
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                       atol=FWD_TOL)
            outs.append(want)
    if name.startswith("modulated"):   # the latent conditions the output
        assert not np.allclose(outs[0], outs[4])


def coherent_loss_jax(jnet, x, target, t, e):
    n = x.shape[0]
    out = jnet(x, time=jnp.full((n,), t), ensemble=jnp.full((n,), e),
               mode="world")
    return jnp.mean(jnp.abs(out - target))


@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax(name, rng):
    """Weights' gradients of an L1 loss against a target."""
    jnet, net = build(name, rng)
    x = rng.random((64, 3)).astype(np.float32)
    n_out = 1 if jnet.output_mode.startswith("density") else 4
    target = rng.random((64, n_out)).astype(np.float32)
    t, e = CONDITIONS[1]
    grads = jax.grad(coherent_loss_jax)(jnet, jnp.asarray(x),
                                        jnp.asarray(target), t, e)
    want = jax_arrays(grads)
    out = net(torch.from_numpy(x), time=torch.full((64,), t),
              ensemble=torch.full((64,), e), mode="world")
    torch.mean(torch.abs(out - torch.from_numpy(target))).backward()
    got = {jax_key(n): p.grad for n, p in net.named_parameters()}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = torch.from_numpy(w)
        g = got[k] if got[k] is not None else torch.zeros_like(w)
        if float(w.norm()) == 0.0:
            assert float(g.norm()) == 0.0, k
            continue
        assert float((g - w).norm() / w.norm()) <= GRAD_RTOL, k


def march_pair(jnet, net, monkeypatch, t=0.0, e=0.0, size=32):
    """(port, JAX) colors of the plain march of each package's network
    volume at ``size``^2, stepsize H, at (time ``t``, ensemble ``e``)."""
    monkeypatch.setattr(type(jnet), "use_direction", False, raising=False)
    rs, rd = jgenerate_rays(JCam.make(pitch=0.3, yaw=0.8, distance=1.6),
                            size, size)
    rs, rd = np.array(rs).reshape(-1, 3), np.array(rd).reshape(-1, 3)
    steps = jmax_steps((1.0, 1.0, 1.0), H)
    want = jtrace(jnp.asarray(rs), jnp.asarray(rd),
                  JVolume.make(jnet, time=t, ensemble=e), JTF.make(**TF),
                  JCfg.make(stepsize=H), steps).color
    with torch.no_grad():
        got = trace_dvr(torch.from_numpy(rs), torch.from_numpy(rd),
                        VolumeInterpolationNetwork(net, time=t, ensemble=e),
                        TransferFunctionPiecewiseLinear.make(**TF),
                        RayEvaluationSteppingDvr.make(stepsize=H),
                        steps).color
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name", NAMES)
def test_plain_march_matches_jax(name, rng, monkeypatch):
    jnet, net = build(name, rng)
    t, e = CONDITIONS[2] if name.startswith("modulated") else (0.0, 0.0)
    got, want = march_pair(jnet, net, monkeypatch, t, e)
    assert want[:, 3].max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=MARCH_TOL)


def assert_fused_refused(net):
    """A FUSED render, the fused marches and the fused screen step of a
    network that is not an SRN raise NotImplementedError naming its class
    (never an AttributeError, never the plain march)."""
    cls = type(net).__name__
    tf = TransferFunctionPiecewiseLinear.make(**TF)
    model = LoadedModel(net, tf, RayEvaluationSteppingDvr.make(stepsize=H))
    cam = CameraOnASphere.make(pitch=0.3, yaw=0.8, distance=1.6)
    for mode in ("FUSED", "FUSED_BF16"):
        with pytest.raises(NotImplementedError, match=cls):
            model.prepare_network_render(cam, 32, 32, mode, device="cpu")
    rs = torch.zeros(256, 3)
    rd = torch.ones(256, 3) / 3 ** 0.5
    box = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))
    with pytest.raises(NotImplementedError, match=cls):
        fused_mega.mega_trace_dvr(rs, rd, net, *box, tf.tensor, stepsize=H)
    with pytest.raises(NotImplementedError, match=cls):
        fused_dvr.fused_trace_dvr(rs, rd, net, *box, tf.tensor, stepsize=H,
                                  max_steps=8)
    with pytest.raises(NotImplementedError, match=cls):
        fused_screen_supported(net, tf, 32, 32)
    # the plain render of the same model works
    img = model.prepare_network_render(cam, 16, 16, "PLAIN32",
                                       device="cpu")()
    assert img.shape == (16, 16, 4) and bool(torch.isfinite(img).all())


@pytest.mark.parametrize("name", ["residual", "modulated"])
def test_fused_paths_refuse_variants(name, rng):
    _, net = build(name, rng)
    assert_fused_refused(net)


def test_residual_sine_trains(rng):
    """The JAX package's check on the port: 100 Adam steps (2e-4) on the
    sphere's densities shrink the MSE below 0.7 of its first value."""
    net = ResidualSineNetwork.make(hidden=16, num_blocks=2,
                                   output_mode="density:direct", seed=4)
    x = rng.random((32, 3)).astype(np.float32)
    vol = JImpl.make("SPHERE")
    world = vol.box_min + x * vol.box_size
    tgt = torch.from_numpy(np.asarray(vol.eval_density(world)[0])[:, None])
    xt = torch.from_numpy(x)
    y = net(xt, mode="world")
    assert y.shape == (32, 1) and bool(torch.isfinite(y).all())
    opt, _ = make_optimizer(net.parameters(), "Adam", lr=2e-4, lr_gamma=1.0)
    losses = []
    for _ in range(100):
        opt.zero_grad()
        loss = torch.mean((net(xt, mode="world") - tgt) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.7 * losses[0]


def test_modulated_sine_outputs_differ_by_ensemble(rng):
    latent = LatentSpace(ensemble_vector=torch.from_numpy(
        rng.random((1, 4, 3)).astype(np.float32)))
    net = ModulatedSineNetwork.make(hidden=16, num_layers=2, latent=latent,
                                    seed=5)
    x = torch.from_numpy(rng.random((16, 3)).astype(np.float32))
    y0 = net(x, ensemble=torch.zeros(16))
    y2 = net(x, ensemble=torch.full((16,), 2.0))
    assert y0.shape == (16, 1) and bool(torch.isfinite(y0).all())
    assert not torch.allclose(y0, y2)
    with pytest.raises(ValueError, match="latent"):
        ModulatedSineNetwork.make(hidden=16)
