"""Port parity, LPIPS (``fvsrn_tpu_torch/train/lpips.py``, the LPIPS term
of ``train/losses.LossNetScreen`` and ``convert.lpips_from_jax``): the
port against the JAX package on the same numpy-seeded images. Random
weights are drawn bit for bit; distances, the loss's total and its
gradient with respect to the prediction agree within 1e-5 relative (both
are float32 convolution stacks, summed in different orders). Weights
loaded from state-dict files written in a temporary directory, by path
and through the ``FVSRN_LPIPS_BACKBONE`` / ``FVSRN_LPIPS_LINEAR``
fallbacks. CPU only."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fvsrn_tpu.train import losses as jlosses
from fvsrn_tpu.train import lpips as jlpips
from fvsrn_tpu_torch.convert import lpips_from_jax
from fvsrn_tpu_torch.train import losses, lpips

torch.set_num_threads(1)

RTOL = 1e-5
# (arch, image size): VGG's four pools need 32^2 at least
SIZES = {"alex": 64, "vgg": 32}
# torchvision's ``features`` indices of the convolutions
FEATURE_INDEX = {"alex": [0, 3, 6, 8, 10],
                 "vgg": [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]}


def images(n, size, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (2, channels, size, size)).astype(np.float32)
            for _ in range(n)]


def assert_rel(got, want, rtol=RTOL, err_msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, err_msg


def assert_same_weights(model, jmodel):
    for name in ("conv_w", "conv_b", "lin_w"):
        got, want = getattr(model, name), getattr(jmodel, name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)


@pytest.mark.parametrize("arch", ["alex", "vgg"])
def test_random_weights_and_distance(arch):
    """``lpips_random`` equals JAX's bit for bit; the distances of two
    seeded (2, 3, S, S) batches agree within 1e-5 relative; the model has
    no parameters (every weight a buffer)."""
    jm = jlpips.lpips_random(arch, seed=3)
    m = lpips.lpips_random(arch, seed=3)
    assert_same_weights(m, jm)
    assert m.arch == arch and not list(m.parameters())
    a, b = images(2, SIZES[arch])
    want = np.asarray(jm(jnp.asarray(a), jnp.asarray(b)))
    got = m(torch.tensor(a), torch.tensor(b)).numpy()
    assert got.shape == want.shape == (2,)
    assert_rel(got, want)
    # identical images are at distance 0
    assert float(m(torch.tensor(a), torch.tensor(a)).abs().max()) == 0.0


def write_weights(tmp_path, arch, seed=5):
    """Torchvision- and v0.1-shaped state dicts of seeded weights:
    (backbone path, linear path)."""
    rng = np.random.default_rng(seed)
    plan = lpips._plan(arch)
    backbone, linear = {}, {}
    cin = 3
    for idx, (o, k, *_rest) in zip(FEATURE_INDEX[arch], plan):
        backbone[f"features.{idx}.weight"] = torch.tensor(
            rng.normal(0, 0.1, (o, cin, k, k)).astype(np.float32))
        backbone[f"features.{idx}.bias"] = torch.tensor(
            rng.normal(0, 0.05, (o,)).astype(np.float32))
        cin = o
    taps = [o for (o, _, _, _, tap, _) in plan if tap]
    for i, c in enumerate(taps):
        # some negative heads: both clamp them to 0
        linear[f"lin{i}.model.1.weight"] = torch.tensor(
            rng.normal(0.01, 0.02, (1, c, 1, 1)).astype(np.float32))
    bpath, lpath = tmp_path / f"{arch}.pth", tmp_path / f"{arch}_lin.pth"
    torch.save(backbone, bpath)
    torch.save(linear, lpath)
    return str(bpath), str(lpath)


@pytest.mark.parametrize("arch", ["alex", "vgg"])
def test_load_lpips(tmp_path, monkeypatch, arch):
    """``load_lpips`` from files by path and through the env fallbacks
    gives JAX's weights bit for bit and its distances within 1e-5
    relative; both raise FileNotFoundError without weights, and both
    refuse a backbone of the other architecture with ValueError."""
    monkeypatch.delenv("FVSRN_LPIPS_BACKBONE", raising=False)
    monkeypatch.delenv("FVSRN_LPIPS_LINEAR", raising=False)
    for load in (lpips.load_lpips, jlpips.load_lpips):
        with pytest.raises(FileNotFoundError, match="not configured"):
            load(arch=arch)
    bpath, lpath = write_weights(tmp_path, arch)
    jm = jlpips.load_lpips(bpath, lpath, arch=arch)
    m = lpips.load_lpips(bpath, lpath, arch=arch)
    assert_same_weights(m, jm)
    a, b = images(2, SIZES[arch], seed=1)
    want = np.asarray(jm(jnp.asarray(a), jnp.asarray(b)))
    assert_rel(m(torch.tensor(a), torch.tensor(b)).numpy(), want)
    monkeypatch.setenv("FVSRN_LPIPS_BACKBONE", bpath)
    monkeypatch.setenv("FVSRN_LPIPS_LINEAR", lpath)
    assert_same_weights(lpips.load_lpips(arch=arch), jm)
    other = "vgg" if arch == "alex" else "alex"
    for load in (lpips.load_lpips, jlpips.load_lpips):
        with pytest.raises(ValueError, match="convs"):
            load(bpath, lpath, arch=other)


@pytest.mark.parametrize("kw", [dict(l1=1.0, lpips=0.5),
                                dict(l2=1.0, dssim=0.3, lpips=2.0,
                                     multiply_alpha=True)])
def test_loss_net_screen_lpips(kw):
    """``LossNetScreen(lpips=..., lpips_model=...)``: total, every
    individual value and the gradient of the total with respect to the
    prediction agree with JAX's (``jax.grad``) within 1e-5 relative."""
    jm = jlpips.lpips_random("alex", seed=2)
    m = lpips.lpips_random("alex", seed=2)
    a, b = images(2, 64, channels=4, seed=4)
    jloss = jlosses.LossNetScreen(lpips_model=jm, **kw)
    jt, jv = jloss(jnp.asarray(a), jnp.asarray(b), return_individual=True)
    jgrad = np.asarray(jax.grad(lambda p: jloss(p, jnp.asarray(b)))(
        jnp.asarray(a)))
    pred = torch.tensor(a, requires_grad=True)
    t, v = losses.LossNetScreen(lpips_model=m, **kw)(
        pred, torch.tensor(b), return_individual=True)
    t.backward()
    assert float(v["lpips"].detach()) > 0
    for key in jv:
        assert_rel(float(v[key]), float(jv[key]), err_msg=key)
    assert_rel(pred.grad.numpy(), jgrad)


def test_lpips_without_model_raises():
    """``lpips > 0`` with no model raises, as in the JAX package, with a
    message that says how to attach one."""
    a, b = images(2, 16, channels=4)
    with pytest.raises(RuntimeError, match="lpips_model=model"):
        losses.LossNetScreen(lpips=1.0)(torch.tensor(a), torch.tensor(b))
    with pytest.raises(RuntimeError):
        jlosses.LossNetScreen(lpips=1.0)(jnp.asarray(a), jnp.asarray(b))


@pytest.mark.parametrize("arch", ["alex", "vgg"])
def test_lpips_from_jax(arch):
    """``convert.lpips_from_jax`` of a JAX model's leaves is that model:
    its weights bit for bit and its distances within 1e-5 relative."""
    jm = jlpips.lpips_random(arch, seed=9)
    m = lpips_from_jax([np.asarray(w) for w in jm.conv_w],
                       [np.asarray(w) for w in jm.conv_b],
                       [np.asarray(w) for w in jm.lin_w], arch=jm.arch)
    assert_same_weights(m, jm)
    a, b = images(2, SIZES[arch], seed=6)
    assert_rel(m(torch.tensor(a), torch.tensor(b)).numpy(),
               np.asarray(jm(jnp.asarray(a), jnp.asarray(b))))
    with pytest.raises(ValueError, match="linear head"):
        lpips_from_jax(jm.conv_w, jm.conv_b, jm.lin_w[:-1], arch=arch)
