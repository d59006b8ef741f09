"""Port parity, the meta-network SRN (``fvsrn_tpu_torch/models/meta.py``
against ``fvsrn_tpu/models/meta.py``): ``make`` with the JAX seeds gives
the JAX weights bit for bit, and so does the converter; the forward on 64
positions is within 1e-5 (absolute) across ensembles and times; the meta
weights' gradients are within 1e-4 relative; ``fit_meta_to_parameters``
after 20 Adam steps predicts within 1e-5 of the largest element of the
JAX fit's predictions; the plain ``trace_dvr`` at 32x32 is within 1e-5 of
the JAX march; the fused paths refuse it; and the JAX package's own tests
(tests/test_meta.py: shapes, parameter count, phase-2 fit, end-to-end
training on two volumes keyed by the ensemble) on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.models.latent import LatentSpace as JLatent
from fvsrn_tpu.models.meta import MetaSceneNetwork as JMeta
from fvsrn_tpu.models.meta import fit_meta_to_parameters as jfit
from fvsrn_tpu.volume.implicit import VolumeInterpolationImplicit as JImpl
from fvsrn_tpu_torch.convert import meta_from_arrays
from fvsrn_tpu_torch.models.latent import LatentSpace
from fvsrn_tpu_torch.models.meta import (MetaSceneNetwork,
                                         fit_meta_to_parameters)
from fvsrn_tpu_torch.train.optimizer import make_optimizer
from tests.test_torch_variants import (CONDITIONS, FWD_TOL, GRAD_RTOL,
                                       MARCH_TOL, assert_fused_refused,
                                       forward_pair, jax_arrays, march_pair,
                                       port_arrays)

torch.set_num_threads(1)
FIT_STEPS = 20
FIT_TOL = 1e-5    # of the largest predicted element


def latents(rng, ensembles=3, times=0):
    """(JAX, port) latent spaces: a 4-channel ensemble vector and, with
    ``times``, a 2-channel time vector."""
    ens = rng.random((1, 4, ensembles)).astype(np.float32)
    tim = rng.standard_normal((1, 2, max(times, 1))).astype(np.float32)
    jkw = dict(ensemble_vector=jnp.asarray(ens))
    kw = dict(ensemble_vector=torch.from_numpy(ens))
    if times:
        jkw["time_vector"] = jnp.asarray(tim)
        kw["time_vector"] = torch.from_numpy(tim)
    return JLatent(**jkw), LatentSpace(**kw)


CASES = {
    "default": dict(),
    "small": dict(layers="16:16", num_fourier=4, seed=1),
    "relu_rgbo": dict(layers="8:8:8", activation="ReLU", meta_layers="32",
                      output_mode="rgbo", num_fourier=2, seed=3),
    "sine_direct": dict(layers="16", activation="Sine:3",
                        meta_activation="Softplus",
                        output_mode="density:direct", fourier_std=0.0,
                        seed=9),
}


def build(name, rng, **latent_kw):
    jlat, lat = latents(rng, **(latent_kw or dict(times=5)))
    kw = CASES[name]
    return JMeta.make(latent=jlat, **kw), MetaSceneNetwork.make(latent=lat,
                                                                **kw)


def convert(jnet):
    return meta_from_arrays(jax_arrays(jnet), {
        "meta_layers": [{"activation": layer.activation,
                         "activation_param": layer.activation_param}
                        for layer in jnet.meta_layers],
        "inner_shapes": jnet.inner_shapes,
        "inner_activation": jnet.inner_activation,
        "inner_act_param": jnet.inner_act_param,
        "output_mode": jnet.output_mode})


@pytest.mark.parametrize("name", sorted(CASES))
def test_make_matches_jax_bit_for_bit(name, rng):
    jnet, net = build(name, rng)
    want = jax_arrays(jnet)
    assert net.inner_shapes == tuple(jnet.inner_shapes)
    for got in (port_arrays(net), port_arrays(convert(jnet))):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name, rng):
    jnet, net = build(name, rng)
    x = rng.random((64, 3)).astype(np.float32)
    outs = []
    for t, e in CONDITIONS:
        got, want = forward_pair(jnet, net, x, t, e, "world")
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=FWD_TOL)
        outs.append(want)
    assert not np.allclose(outs[0], outs[2])


@pytest.mark.parametrize("name", ["small", "relu_rgbo"])
def test_gradients_match_jax(name, rng):
    jnet, net = build(name, rng)
    x = rng.random((64, 3)).astype(np.float32)
    n_out = 1 if jnet.output_mode.startswith("density") else 4
    target = rng.random((64, n_out)).astype(np.float32)
    t, e = CONDITIONS[1]

    def loss(jnet):
        out = jnet(jnp.asarray(x), time=jnp.full((64,), t),
                   ensemble=jnp.full((64,), e), mode="world")
        return jnp.mean(jnp.abs(out - jnp.asarray(target)))

    want = jax_arrays(jax.grad(loss)(jnet))
    out = net(torch.from_numpy(x), time=torch.full((64,), t),
              ensemble=torch.full((64,), e), mode="world")
    torch.mean(torch.abs(out - torch.from_numpy(target))).backward()
    got = dict(net.named_parameters())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = torch.from_numpy(w)
        g = got[k].grad if got[k].grad is not None else torch.zeros_like(w)
        if float(w.norm()) == 0.0:
            assert float(g.norm()) == 0.0, k
            continue
        assert float((g - w).norm() / w.norm()) <= GRAD_RTOL, k


def test_fit_matches_jax(rng):
    """Phase 2, 20 steps: the fitted copy's predictions against the JAX
    fit's; the original is left as it is."""
    jnet, net = build("small", rng)
    p = jnet.predict_parameters(jnp.zeros(6)).shape[0]
    target = (rng.standard_normal(p) * 0.1).astype(np.float32)
    zs = rng.random((5, 6)).astype(np.float32)
    jfitted = jfit(jnet, jnp.asarray(zs), jnp.asarray(target),
                   steps=FIT_STEPS, lr=3e-3)
    want = np.asarray(jax.vmap(jfitted.predict_parameters)(jnp.asarray(zs)))
    before = {k: v.copy() for k, v in port_arrays(net).items()}
    fitted = fit_meta_to_parameters(net, torch.from_numpy(zs),
                                    torch.from_numpy(target),
                                    steps=FIT_STEPS, lr=3e-3)
    got = fitted.predict_parameters(torch.from_numpy(zs)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FIT_TOL * np.abs(want).max())
    for k, v in port_arrays(net).items():
        assert v.tobytes() == before[k].tobytes(), k


def test_plain_march_matches_jax(rng, monkeypatch):
    jnet, net = build("small", rng)
    got, want = march_pair(jnet, net, monkeypatch, *CONDITIONS[1])
    assert want[:, 3].max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=MARCH_TOL)


def test_fused_paths_refuse_meta(rng):
    _, net = build("small", rng)
    assert_fused_refused(net)


def test_meta_forward_shapes(rng):
    _, net = build("small", rng, ensembles=3)
    x = torch.from_numpy(rng.random((10, 3)).astype(np.float32))
    y = net(x, ensemble=torch.zeros(10))
    assert y.shape == (10, 1)
    y2 = net(x, ensemble=torch.full((10,), 2.0))
    assert not torch.allclose(y, y2)


def test_meta_param_count(rng):
    jlat, lat = latents(rng)
    net = MetaSceneNetwork.make(layers="8:8", num_fourier=2, latent=lat)
    p = net.predict_parameters(torch.zeros(4))
    pairs = net._unpack(p)
    assert len(pairs) == 3   # 2 hidden + output
    assert sum(w.numel() + b.numel() for w, b in pairs) == p.shape[0]
    with pytest.raises(ValueError, match="latent"):
        MetaSceneNetwork.make()


def test_meta_pretraining_fit(rng):
    """Phase 2 (the JAX package's check, 300 steps): the meta net learns
    to emit a fixed parameter vector for every training latent."""
    _, lat = latents(rng)
    net = MetaSceneNetwork.make(layers="8:8", num_fourier=2, latent=lat,
                                seed=2)
    n_params = net.predict_parameters(torch.zeros(4)).shape[0]
    target = torch.from_numpy(
        (rng.standard_normal(n_params) * 0.1).astype(np.float32))
    zs = torch.from_numpy(rng.random((5, 4)).astype(np.float32))
    fitted = fit_meta_to_parameters(net, zs, target, steps=300, lr=3e-3)
    with torch.no_grad():
        err = float((fitted.predict_parameters(zs) - target[None]).abs()
                    .mean())
    assert err < 0.02, err


def test_meta_end_to_end_training(rng):
    """The meta SRN fits two different volumes keyed by the ensemble (the
    JAX package's check)."""
    _, lat = latents(rng, ensembles=2)
    vols = [JImpl.make("SPHERE"), JImpl.make("CUBE")]
    net = MetaSceneNetwork.make(layers="16:16", num_fourier=4, latent=lat,
                                output_mode="density:direct", seed=3)
    opt, _ = make_optimizer(net.parameters(), "Adam", lr=3e-3,
                            lr_gamma=1.0)
    pos_np = rng.random((2048, 3)).astype(np.float32)
    pos = torch.from_numpy(pos_np)
    targets = [torch.from_numpy(np.asarray(v.eval_density(
        v.box_min + pos_np * v.box_size)[0])[:, None]) for v in vols]
    first = last = None
    for i in range(50):
        tot = 0.0
        for e, tgt in enumerate(targets):
            opt.zero_grad()
            pred = net(pos, ensemble=torch.full((2048,), float(e)),
                       mode="world")
            loss = torch.mean(torch.abs(pred - tgt))
            loss.backward()
            opt.step()
            tot += float(loss.detach())
        if i == 0:
            first = tot
        last = tot
    assert last < 0.6 * first, (first, last)
