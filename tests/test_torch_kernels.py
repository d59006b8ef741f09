"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the megakernel's render forward, its differentiable forward
(image, stored carries, segments visited) and backward (every gradient
leaf, also with no latent grid and with a TF whose first knot absorbs),
the per-segment engine (csrc/segment_fwd.cu: every network and option it
takes, image, samples and the call's stop) and its differentiable pair
(csrc/segment_fwd.cu storing carries, csrc/segment_bwd.cu: image and
every gradient leaf over the same networks and options) and the sample
evaluator (csrc/sample_eval.cu: density and its position gradient at
scattered positions, at sizes around its tiles and its persistent grid,
at path-like positions, and its plan and grid against the host mirror),
the occupancy mask in all three megakernel launches, the probe kernels of
rows 8-11 (csrc/probes.cu; the prototype also at other tile and segment
counts), and the edges of the two forwards' warp-owned tiles
(csrc/warp_mlp.cuh) and of the backwards' block tiles
(csrc/sample_mlp.cuh). This file imports no JAX, so it runs where the GPU
is:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU
machine does not have). Without a card the kernel tests skip; the
checks of what the kernel takes run anywhere.
"""
import copy
import math

import numpy as np
import pytest
import torch

from fvsrn_tpu_torch.camera import CameraOnASphere, generate_rays
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.inference import pad_rays
from fvsrn_tpu_torch.models.activations import apply_activation
from fvsrn_tpu_torch.models.latent import grid_sample_3d
from fvsrn_tpu_torch.ops import (fused_dvr, fused_dvr_bwd, fused_eval,
                                 fused_mega)
from fvsrn_tpu_torch.ops.fused_dvr import block_ray_permutation
from fvsrn_tpu_torch.ops.sample_mlp import TF_STAGED_POINTS
from fvsrn_tpu_torch.scenes import dense_scene, dense_tf_points
from fvsrn_tpu_torch.train.checkpoints import load_weights
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear

torch.set_num_threads(1)
ATOL = 1e-4       # float32 kernel vs plain: the fused-vs-oracle contract
BOX = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))


def random_net(seed=3, activation="SnakeAlt", output_mode="density:direct",
               channels=8, fourier=6, width=32, out_bias=0.4, direction=False,
               act_param=2.0, hidden=3, widths=None):
    """An SRN of ``hidden`` hidden layers with torch Linear-style random
    weights; no latent grid with ``channels=0``. ``out_bias`` sets the
    density's level (0.4 a visible density, 0.0 clips about half the
    samples at 0); ``direction`` adds the ray direction to the input and
    to the Fourier features; ``widths`` (one a hidden layer) replaces
    ``width`` and ``hidden`` (layers of mixed widths)."""
    rng = np.random.default_rng(seed)
    n_out_head = 1 if output_mode.startswith("density") else 4
    n_in = 6 if direction else 3
    if widths is None:
        widths = [width] * hidden
    hidden = len(widths)
    sizes = [n_in + 2 * fourier + channels] + list(widths) + [n_out_head]
    arrays = {"input.fourier_matrix": rng.normal(0.0, 2 * math.pi,
                                                 (fourier, n_in))}
    grid = rng.standard_normal((channels, 8, 8, 8)) * 0.3
    if channels:
        arrays["latent.static_grid"] = grid
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        bound = 1.0 / math.sqrt(a)
        arrays[f"layers.{i}.weight"] = rng.uniform(-bound, bound, (b, a))
        arrays[f"layers.{i}.bias"] = rng.uniform(-bound, bound, b)
        layers.append({"activation": activation if i < hidden else "None",
                       "activation_param": act_param})
    if n_out_head == 1:
        arrays[f"layers.{hidden}.bias"] = np.asarray([out_bias])
    return srn_from_arrays(arrays, {
        "layers": layers, "output_mode": output_mode,
        "has_direction": direction,
        "disable_direction_in_fourier": not direction})


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def block_rays(width, device, distance=1.6):
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.5,
                                                distance=distance),
                           width, width, device=device)
    perm, _ = block_ray_permutation(width, width, 16, 16, device=device)
    return (rs.reshape(-1, 3)[perm].contiguous(),
            rd.reshape(-1, 3)[perm].contiguous())


@pytest.mark.parametrize("which", ["random", "flagship"])
@pytest.mark.parametrize("early_out", [True, False])
def test_mega_kernel_matches_plain(which, early_out):
    needs_card()
    _, tf, npz = dense_scene()
    net = (random_net() if which == "random" else load_weights(npz)).cuda()
    rs, rd = block_rays(64, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    args = (rs, rd, net, *BOX, tf.tensor.cuda())
    kw = dict(stepsize=1 / 128, tmax_clip=clip, enable_early_out=early_out,
              return_samples=True)
    before = fused_mega.launches("mega_fwd")
    got, samples = fused_mega.mega_trace_dvr(*args, **kw)
    torch.cuda.synchronize()
    assert fused_mega.launches("mega_fwd") == before + 1
    want, samples_plain = fused_mega.mega_trace_dvr_plain(*args, **kw)
    assert fused_mega.launches("mega_fwd") == before + 1
    assert float(want[:, 3].max()) > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert torch.equal(samples.long(), samples_plain)


def case_net(which):
    """The network of a card case: "random", "nogrid" (random, without a
    latent grid), "width64" (random, 64 wide), "relu48" (random, 48-wide
    ReLU) or "flagship"."""
    _, _, npz = dense_scene()
    if which == "flagship":
        return load_weights(npz).cuda()
    kw = {"nogrid": dict(channels=0), "width64": dict(width=64),
          "relu48": dict(width=48, activation="ReLU")}.get(which, {})
    return random_net(**kw).cuda()


def diff_case(which, early_out, net=None, tf=None):
    """(net, tf, packet, spec) of a 64x64 clipped view on the card."""
    net = case_net(which) if net is None else net
    tf = dense_scene()[1].tensor if tf is None else tf
    rs, rd = block_rays(64, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    h = 1 / 128
    spec = fused_mega._spec(net, *BOX, stepsize=h, seg=32, tile=256,
                            density_min=0.0, density_max=1.0,
                            enable_early_out=early_out)
    rays = fused_mega.ray_packet(rs, rd, *BOX, h, clip)
    return net, tf.cuda(), rays, spec


@pytest.mark.parametrize("which", ["random", "nogrid", "flagship"])
@pytest.mark.parametrize("early_out", [True, False])
def test_mega_diff_forward_matches_plain(which, early_out):
    """Row 2: image, the carries entering every visited segment, and the
    number of segments each tile visited."""
    needs_card()
    net, tf, rays, spec = diff_case(which, early_out)
    params = fused_mega._params(net, tf)
    n_fourier, n_hidden, tf_points, _ = fused_mega._widths(params)
    n_seg = fused_mega.segments_needed(rays, spec)
    with torch.no_grad():
        out, samples, carries, count = fused_mega._launch_fwd(
            rays, fused_mega._pack_weights(params, spec),
            fused_mega._kernel_table(params[2], torch.float32, rays.device),
            spec,
            n_fourier, n_hidden, tf_points, n_seg_max=n_seg)
        torch.cuda.synchronize()
        want, want_samples, want_carries, want_count = \
            fused_mega._plain_march(spec, rays, params, store=True)
    assert float(want[:, 3].max()) > 0.5
    torch.testing.assert_close(out, want, rtol=0, atol=ATOL)
    assert torch.equal(samples.long(), want_samples)
    assert torch.equal(count.long(), want_count)
    for t in range(count.shape[0]):
        c = int(count[t])
        torch.testing.assert_close(carries[t, :c], want_carries[t, :c],
                                   rtol=0, atol=ATOL)


def kernel_and_plain_grads(net, tf, rays, spec, mask=None):
    """Gradients of sum(w * rgba), w random, through the kernels and
    through the plain version (both with the occupancy ``mask`` of
    ``fused_mega._check_mask``, or none): two dicts keyed by leaf, the TF
    as "tf"."""
    w = torch.empty(rays.shape[0], 4, device="cuda").uniform_(
        -1, 1, generator=torch.Generator("cuda").manual_seed(1))
    grads = {}
    for fn in (fused_mega._KernelMarch, fused_mega._PlainMarch):
        net.zero_grad(set_to_none=True)
        tf_leaf = tf.clone().requires_grad_(True)
        before = fused_mega.launches("mega_bwd")
        table = ((torch.float32,) if fn is fused_mega._KernelMarch else ())
        img, _ = fn.apply(rays, spec, mask, *table,
                          *fused_mega._params(net, tf_leaf))
        (img * w).sum().backward()
        torch.cuda.synchronize()
        launched = fused_mega.launches("mega_bwd") - before
        assert launched == (1 if fn is fused_mega._KernelMarch else 0)
        g = {n: p.grad.clone() for n, p in net.named_parameters()}
        g["tf"] = tf_leaf.grad.clone()
        grads[fn] = g
    return grads[fused_mega._KernelMarch], grads[fused_mega._PlainMarch]


def rel_err(got, want):
    assert float(want.norm()) > 0
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("which", ["random", "nogrid", "flagship"])
@pytest.mark.parametrize("early_out", [True, False])
def test_mega_backward_matches_plain(which, early_out):
    """Row 3: every gradient leaf (Fourier matrix, each weight and bias,
    the latent grid, the TF) within a relative norm error of 1e-3."""
    needs_card()
    got, want = kernel_and_plain_grads(*diff_case(which, early_out))
    assert sorted(got) == sorted(want)
    for name in want:
        assert rel_err(got[name], want[name]) <= 1e-3, name


@pytest.mark.parametrize("early_out", [True, False])
def test_mega_backward_absorbing_first_knot(early_out):
    """About half the samples clip at value 0, exactly at the first knot
    of a TF that absorbs there: the kernel's adjoint gives those samples'
    knot positions no gradient (interior-only), as the plain version's
    gates do. The TF's knot-position column is also compared alone."""
    needs_card()
    net = random_net(out_bias=0.0).cuda()
    x = torch.rand(4096, 3, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    with torch.no_grad():
        clipped = float((net(x)[:, 0] == 0).float().mean())
    assert 0.1 < clipped < 0.9
    tf = TransferFunctionPiecewiseLinear.make(
        rgb=[[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9]],
        opacity=[2.0, 10.0, 30.0], positions=[0.0, 0.45, 1.0]).tensor
    got, want = kernel_and_plain_grads(*diff_case("random", early_out,
                                                  net=net, tf=tf))
    for name in want:
        assert rel_err(got[name], want[name]) <= 1e-3, name
    assert rel_err(got["tf"][:, 4], want["tf"][:, 4]) <= 1e-3


# the networks of the paper's sweeps beyond the flagship's shape: widths
# (20 runs zero-padded to 32), activations, output heads, direction input
NETWORK_CASES = {
    "width20": dict(width=20), "width48": dict(width=48),
    "width64": dict(width=64, fourier=14),
    "width64_nogrid": dict(width=64, channels=0, hidden=2),
    "relu": dict(activation="ReLU"),
    "sine3": dict(activation="Sine", act_param=3.0),
    "sine30": dict(activation="Sine", act_param=30.0),
    "snake": dict(activation="Snake", act_param=1.0),
    "sigmoid": dict(activation="Sigmoid"),
    "softplus": dict(activation="Softplus"),
    "rgbo": dict(output_mode="rgbo"), "rgbo_exp": dict(output_mode="rgbo:exp"),
    "direction": dict(direction=True),
    "direction_rgbo48": dict(direction=True, output_mode="rgbo", width=48),
}


# Sine:30 is ill-conditioned in float32 (30x pre-activations): one ulp of
# seeded weight noise moves the plain version's image by 6.5e-4 to 9.1e-4
# at 64x64 and its gradient leaves by 0.4-4.7% on a 16x16 view (on the
# CPU, tools/port_conditioning.py). Its kernel-vs-plain
# distances are held to NOISE_FLIP times the plain version's own change
# under NOISE_EPS relative weight noise (ATOL and 1e-3 at least), and its
# tile votes may flip with it (samples not compared).
ILL_CONDITIONED = {"sine30"}
NOISE_EPS = 1e-7
NOISE_FLIP = 5.0


def noisy_copy(net, seed=3):
    """``net`` with every parameter times (1 + NOISE_EPS * N(0, 1))."""
    out = copy.deepcopy(net)
    gen = torch.Generator("cuda").manual_seed(seed)
    with torch.no_grad():
        for p in out.parameters():
            p.mul_(1.0 + NOISE_EPS * torch.randn(p.shape, device=p.device,
                                                 generator=gen))
    return out


@pytest.mark.parametrize("case", sorted(NETWORK_CASES))
def test_mega_networks_match_plain(case):
    """Rows 1-3 over NETWORK_CASES: the render (bf16 table, the tile vote
    on) image and samples, then the differentiable pair's image and
    every gradient leaf (relative norm error 1e-3) against the plain
    versions; Sine:30 within its float32 conditioning (above). An rgbo
    head reads no TF: its TF gradient is zero."""
    needs_card()
    net = random_net(**NETWORK_CASES[case]).cuda()
    ill = case in ILL_CONDITIONED
    rs, rd = block_rays(64, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    args = (rs, rd, net, *BOX, dense_scene()[1].tensor.cuda())
    kw = dict(stepsize=1 / 128, tmax_clip=clip, return_samples=True)
    before = fused_mega.launches("mega_fwd")
    got, samples = fused_mega.mega_trace_dvr(*args, **kw)
    torch.cuda.synchronize()
    assert fused_mega.launches("mega_fwd") == before + 1
    want, samples_plain = fused_mega.mega_trace_dvr_plain(*args, **kw)
    assert float(want[:, 3].max()) > 0.2
    atol, gtol = ATOL, {}
    if ill:
        noisy = noisy_copy(net)
        moved, _ = fused_mega.mega_trace_dvr_plain(rs, rd, noisy, *args[3:],
                                                   **kw)
        atol = max(ATOL, NOISE_FLIP * float((moved - want).abs().max()))
        _, g_noisy = kernel_and_plain_grads(*diff_case("random", True,
                                                       net=noisy))
    else:
        assert torch.equal(samples.long(), samples_plain)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    got, want = kernel_and_plain_grads(*diff_case("random", True, net=net))
    assert sorted(got) == sorted(want)
    for name in want:
        if name == "tf" and not net.output_mode.startswith("density"):
            assert not got[name].any() and not want[name].any()
            continue
        tol = (max(1e-3, NOISE_FLIP * rel_err(g_noisy[name], want[name]))
               if ill else 1e-3)
        assert rel_err(got[name], want[name]) <= tol, name


def random_mask(rays, spec, seed=2):
    """A seeded occupancy mask culling about a third of the (tile,
    segment) programs."""
    n_seg = fused_mega.segments_needed(rays, spec)
    keep = torch.rand(rays.shape[0] // 256, n_seg, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(seed))
    return fused_mega._check_mask(keep > 0.33, rays.shape[0] // 256,
                                  rays.device)


@pytest.mark.parametrize("which", ["random", "flagship", "relu48"])
@pytest.mark.parametrize("early_out", [True, False])
def test_mega_masked_matches_plain(which, early_out):
    """B1: the occupancy mask in all three launches. The render forward
    (bf16 table), the differentiable forward's image and carries, and
    every gradient leaf of the backward against the plain versions with
    the same mask; the mask culls samples."""
    needs_card()
    net, tf, rays, spec = diff_case(which, early_out)
    mask = random_mask(rays, spec)
    rs, rd = block_rays(64, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    kw = dict(stepsize=1 / 128, tmax_clip=clip, enable_early_out=early_out,
              return_samples=True)
    args = (rs, rd, net, *BOX, tf)
    got, samples = fused_mega.mega_trace_dvr(*args, segment_active=mask, **kw)
    want, samples_plain = fused_mega.mega_trace_dvr_plain(
        *args, segment_active=mask, **kw)
    _, unmasked = fused_mega.mega_trace_dvr(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert torch.equal(samples.long(), samples_plain)
    assert int(samples.sum()) < int(unmasked.sum())
    params = fused_mega._params(net, tf)
    n_fourier, n_hidden, tf_points, _ = fused_mega._widths(params)
    with torch.no_grad():
        out, _, carries, count = fused_mega._launch_fwd(
            rays, fused_mega._pack_weights(params, spec),
            fused_mega._kernel_table(params[2], torch.float32, rays.device),
            spec, n_fourier, n_hidden, tf_points,
            n_seg_max=fused_mega.segments_needed(rays, spec), mask=mask)
        want, _, want_carries, want_count = fused_mega._plain_march(
            spec, rays, params, store=True, mask=mask)
    torch.testing.assert_close(out, want, rtol=0, atol=ATOL)
    assert torch.equal(count.long(), want_count)
    for t in range(count.shape[0]):
        c = int(count[t])
        torch.testing.assert_close(carries[t, :c], want_carries[t, :c],
                                   rtol=0, atol=ATOL)
    got, want = kernel_and_plain_grads(net, tf, rays, spec, mask)
    for name in want:
        assert rel_err(got[name], want[name]) <= 1e-3, name


@pytest.mark.parametrize("case", ["gather_f32", "gather_bf16",
                                  "chunked_928", "onehot_128",
                                  "onehot_928", "proto"])
def test_probe_kernels_match_plain(case):
    """Rows 8-11 (csrc/probes.cu) against their plain versions and the JAX
    tools' NumPy oracles, at the tools' shapes: the gathers and the
    resolve exact, the prototype's output within 1e-5 relative and its
    counts exact; each launch counted."""
    needs_card()
    from fvsrn_tpu_torch.ops import probes
    from fvsrn_tpu_torch.tools import probe_lane_gather as g
    from fvsrn_tpu_torch.tools import proto_mega
    probes.reset_counts()
    if case == "proto":
        res = proto_mega.run("cuda", iters=2)
        assert res["ok"] and res["dtab_abs_err"] == 0.0
        cmp = proto_mega.run("cuda", compare=True)
        assert cmp["plain_max_abs_err"] <= 1e-5
        assert probes.counts()["proto_mega"] >= 3
        return
    fn = {"gather_f32": lambda **k: g.probe_gather_single(torch.float32,
                                                          "cuda", **k),
          "gather_bf16": lambda **k: g.probe_gather_single(torch.bfloat16,
                                                           "cuda", **k),
          "chunked_928": lambda **k: g.probe_gather_chunked(928, "cuda",
                                                            **k),
          "onehot_128": lambda **k: g.probe_onehot(128, "cuda", **k),
          "onehot_928": lambda **k: g.probe_onehot(928, "cuda", **k)}[case]
    res = fn(iters=2)
    assert res["ok"] and res["max_abs_err"] == 0.0
    assert fn(iters=2, compare=True)["plain_max_abs_err"] == 0.0
    assert sum(probes.counts().values()) >= 4


@pytest.mark.parametrize("tiles,n_seg", [(1, 1), (1, 5), (16, 1), (16, 5)])
def test_proto_mega_shapes(tiles, n_seg):
    """Row 8 at other shapes than the tool's (T = 4, S = 3): T tiles of
    128 rays, S segments, boxes spread over the table; the output within
    1e-5 relative of the plain version and the counts exact."""
    needs_card()
    from fvsrn_tpu_torch.ops import probes
    rng = np.random.default_rng(tiles * 10 + n_seg)
    # each tile's rows around a base of its own: its minima (the box
    # starts) differ from tile to tile
    base = np.repeat(rng.integers(0, 30, (8, tiles)), 128, axis=1)
    rays = torch.from_numpy((base + rng.integers(0, 4, (8, tiles * 128)))
                            .astype(np.float32)).cuda()
    tab = torch.from_numpy(rng.standard_normal((34, 34, 640)).astype(
        np.float32)).cuda()
    before = probes.PROTO_LAUNCHES
    out, cnt = probes.proto_mega(rays, tab, n_seg)
    torch.cuda.synchronize()
    assert probes.PROTO_LAUNCHES == before + 1
    p_out, p_cnt = probes.proto_mega_plain(rays, tab, n_seg)
    scale = max(1.0, float(p_out.abs().max()))
    assert float((out - p_out).abs().max()) / scale <= 1e-5
    assert torch.equal(cnt, p_cnt)


@pytest.mark.parametrize("rows,c,n", [(128, 128, 8192), (928, 128, 8192),
                                      (128, 128, 1000), (928, 128, 8193),
                                      (17, 12, 37), (5, 8, 130)])
def test_onehot_resolve_shapes(rows, c, n):
    """Row 11 (the resolve, transposed in registers: a warp owns 128
    samples, 4 a lane) against its plain version, exactly: the tools'
    shapes, n not a multiple of a warp's 128 samples (1000) nor of a
    lane's 4 (8193, 37: the scalar path), a C that takes 8-byte loads (12)
    and row ids outside the table (zeros)."""
    needs_card()
    from fvsrn_tpu_torch.ops import probes
    rng = np.random.default_rng(rows + c + n)
    tab = torch.from_numpy(rng.standard_normal((rows, c)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    lrow = torch.from_numpy(rng.integers(-3, rows + 3, (1, n)).astype(
        np.int32)).cuda()
    before = probes.ONEHOT_LAUNCHES
    out = probes.onehot_resolve(tab, lrow)
    torch.cuda.synchronize()
    assert probes.ONEHOT_LAUNCHES == before + 1
    assert out.shape == (c, n)
    assert torch.equal(out, probes.onehot_resolve_plain(tab, lrow))


def test_proto_mega_box_limit():
    """Row 8 takes at most PROTO_MAX_BOXES tiles x segments on the card
    (every block holds the box starts in shared memory): one box more is
    refused before any launch."""
    needs_card()
    from fvsrn_tpu_torch.ops import probes
    tiles = probes.PROTO_MAX_BOXES // 4
    rays = torch.zeros(8, tiles * probes.TILE, device="cuda")
    tab = torch.zeros(6, 16, 256, device="cuda")
    before = probes.PROTO_LAUNCHES
    probes.proto_mega(rays, tab, 4)
    with pytest.raises(ValueError, match="boxes"):
        probes.proto_mega(rays, tab, 5)
    torch.cuda.synchronize()
    assert probes.PROTO_LAUNCHES == before + 1


@pytest.mark.parametrize("net_kw,tile", [
    (dict(width=160), 256),
    (dict(hidden=fused_mega.MAX_HIDDEN_LAYERS + 2), 256),
    (dict(channels=20), 256),
    (dict(activation="ReLU", tf_mode="gaussian"), 256),
    ({}, 64),
    (dict(width=128, need_normals=True, tf_mode="texture"), 256),
    (dict(width=96), 128),
    (dict(widths=[64, 32], differentiable=True), 256),
    (dict(widths=[48, 96], differentiable=True), 256)])
def test_mega_kernel_rejects_what_it_does_not_take(net_kw, tile):
    """What the kernels refuse: hidden layers wider than 128, more than
    MAX_HIDDEN_LAYERS + 1 of them, more than 16 latent channels, a
    Gaussian TF on a network other than SnakeAlt in the render, tiles of
    other than 256 rays, normals with a TF mode other than piecewise (at
    width 128 too), 128-ray tiles above 64 wide, layers of several widths
    in training; and what they take (widths to 128, every activation and
    head, direction input, no grid; the texture TF on a ReLU network with
    direction input in the render and in training; mixed widths in the
    render; normals at every width)."""
    rays = torch.zeros(512, 8)
    net_kw = dict(net_kw)
    tf_mode = net_kw.pop("tf_mode", "piecewise")
    diff = net_kw.pop("differentiable", False)
    normals = net_kw.pop("need_normals", False)
    with pytest.raises(NotImplementedError):
        fused_mega._check_kernel_inputs(random_net(**net_kw), rays, tile,
                                        tf_floats=1024, tf_mode=tf_mode,
                                        differentiable=diff,
                                        need_normals=normals)
    for diff in (False, True):
        fused_mega._check_kernel_inputs(
            random_net(activation="ReLU", direction=True), rays, 256,
            tf_floats=1024, tf_mode="texture", differentiable=diff)
    for kw in ({}, dict(channels=0), dict(width=20), dict(width=64),
               dict(width=96), dict(width=128),
               dict(width=128, hidden=fused_mega.MAX_HIDDEN_LAYERS + 1),
               dict(hidden=fused_mega.MAX_HIDDEN_LAYERS + 1),
               dict(activation="Sine", act_param=30.0),
               dict(output_mode="rgbo:exp"), dict(direction=True),
               dict(width=96, activation="ReLU", direction=True)):
        fused_mega._check_kernel_inputs(random_net(**kw), rays, 256,
                                        differentiable=True)
    fused_mega._check_kernel_inputs(random_net(width=48), rays, 256,
                                    tf_floats=1024, tf_mode="texture")
    for widths in ([64, 32], [48, 96], [128, 20, 72]):
        fused_mega._check_kernel_inputs(random_net(widths=widths), rays, 256)
        fused_mega._check_kernel_inputs(random_net(widths=widths), rays, 256,
                                        need_normals=True)
    for width in (96, 128):
        fused_mega._check_kernel_inputs(random_net(width=width), rays, 256,
                                        need_normals=True)
    for tile in fused_mega.KERNEL_TILES:   # bench.py's 128, the render's 256
        fused_mega._check_kernel_inputs(random_net(width=64), rays, tile,
                                        differentiable=True)


@pytest.mark.parametrize("case", ["ray_grads", "seg"])
def test_mega_backward_rejects_what_it_does_not_take(case):
    """The backward kernel takes 32-point segments only; rays that carry a
    gradient (its ray-gradient instances) it takes, on both tiles."""
    rays = torch.zeros(512, 8, requires_grad=(case == "ray_grads"))
    if case == "seg":
        with pytest.raises(NotImplementedError):
            fused_mega._check_kernel_inputs(random_net(), rays, 256, 16,
                                            differentiable=True)
    for tile in fused_mega.KERNEL_TILES:
        fused_mega._check_kernel_inputs(random_net(), rays, tile, 32,
                                        differentiable=True)


# ---------------------------------------------------------------------------
# bench.py's configuration (tile 128, a bf16 table under training) and the
# ray gradients of row 3


def bench_case(which, width=64, tile=128):
    """(rays, ray direction, net, tf, clip) of a width^2 view in bench.py's
    16x8 pixel blocks, a clip that kills one ray of the second tile (so a
    256-ray tile holding it never votes stop)."""
    net = case_net(which)
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.5,
                                                distance=1.3),
                           width, width, device="cuda")
    perm, _ = block_ray_permutation(width, width, 16, 8, device="cuda")
    rs = rs.reshape(-1, 3)[perm].contiguous()
    rd = rd.reshape(-1, 3)[perm].contiguous()
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    clip[tile + 72] = 0.0
    return rs, rd, net, dense_scene()[1].tensor.cuda(), clip


@pytest.mark.parametrize("which", ["random", "flagship", "width64"])
@pytest.mark.parametrize("early_out", [True, False])
def test_mega_tile128_render_matches_plain(which, early_out):
    """Row 1 on 128-ray tiles (the _t128 libraries): image and samples
    against the plain version, at tile 256 too; the two tiles' kernels
    differ from each other as the plain versions do (where the vote fires
    elsewhere; tests/test_torch_bench_config.py shows that it does)."""
    needs_card()
    rs, rd, net, tf, clip = bench_case(which)
    args = (rs, rd, net, *BOX, tf)
    out = {}
    for tile in (128, 256):
        kw = dict(stepsize=1 / 128, tmax_clip=clip, tile=tile,
                  enable_early_out=early_out, alpha_early_out=0.95,
                  return_samples=True)
        before = fused_mega.launches("mega_fwd")
        got, samples = fused_mega.mega_trace_dvr(*args, **kw)
        torch.cuda.synchronize()
        assert fused_mega.launches("mega_fwd") == before + 1
        want, samples_plain = fused_mega.mega_trace_dvr_plain(*args, **kw)
        assert float(want[:, 3].max()) > 0.5
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        assert torch.equal(samples.long(), samples_plain)
        out[tile] = (got, want)
    (k128, p128), (k256, p256) = out[128], out[256]
    torch.testing.assert_close(k128 - k256, p128 - p256, rtol=0,
                               atol=2 * ATOL)


@pytest.mark.parametrize("which", ["random", "nogrid", "flagship"])
@pytest.mark.parametrize("table", ["bf16", "f32"])
@pytest.mark.parametrize("early_out", [True, False])
def test_mega_tile128_training_matches_plain(which, table, early_out):
    """Rows 2-3 in bench.py's configuration: tile 128, seg 32, the bf16
    table under training (and the float32 one): image <= 1e-4, every
    leaf within a relative norm error of 1e-3, a bf16 grid's gradient per
    element (``bf16_grid_close``). One launch of each kernel."""
    needs_card()
    rs, rd, net, tf, clip = bench_case(which)
    dtype = torch.bfloat16 if table == "bf16" else torch.float32
    w = torch.empty(rs.shape[0], 4, device="cuda").uniform_(
        -1, 1, generator=torch.Generator("cuda").manual_seed(1))
    got = {}
    for fn in (fused_mega.mega_trace_dvr, fused_mega.mega_trace_dvr_plain):
        net.zero_grad(set_to_none=True)
        tf_leaf = tf.clone().requires_grad_(True)
        before = (fused_mega.launches("mega_fwd_diff"),
                  fused_mega.launches("mega_bwd"))
        img = fn(rs, rd, net, *BOX, tf_leaf, stepsize=1 / 128,
                 tmax_clip=clip, tile=128, enable_early_out=early_out,
                 differentiable=True, table_dtype=dtype)
        (img * w).sum().backward()
        torch.cuda.synchronize()
        launched = (fused_mega.launches("mega_fwd_diff") - before[0],
                    fused_mega.launches("mega_bwd") - before[1])
        assert launched == ((1, 1) if fn is fused_mega.mega_trace_dvr
                            else (0, 0))
        g = {n: p.grad.clone() for n, p in net.named_parameters()}
        g["tf"] = tf_leaf.grad.clone()
        got[fn] = (img.detach(), g)
    (img_k, g_k), (img_p, g_p) = got.values()
    assert float(img_p[:, 3].max()) > 0.5
    torch.testing.assert_close(img_k, img_p, rtol=0, atol=ATOL)
    for name in g_p:
        if name == "latent.static_grid" and table == "bf16":
            bf16_grid_close(g_k[name], g_p[name])
        else:
            assert rel_err(g_k[name], g_p[name]) <= 1e-3, name


class position_noise:
    """Within the block, ``fused_mega.ray_packet`` multiplies each ray's
    start and direction columns by (1 + NOISE_EPS * N(0, 1)) after k0 and
    tmax are taken: the samples' positions move by about an ulp, the
    lattice does not. A ray's gradient takes each sample's trilinear
    derivative, which jumps where a sample crosses a latent cell's face,
    so an ulp moves it: the plain version's own change under this noise
    is the float32 floor of a kernel-vs-plain comparison."""

    def __enter__(self):
        self.orig = fused_mega.ray_packet
        gen = torch.Generator("cuda").manual_seed(5)

        def noisy(*args, **kw):
            p = self.orig(*args, **kw)
            scale = torch.ones_like(p)
            scale[:, :6] += NOISE_EPS * torch.randn(
                p[:, :6].shape, device=p.device, generator=gen)
            return p * scale
        fused_mega.ray_packet = noisy

    def __exit__(self, *exc):
        fused_mega.ray_packet = self.orig


def ray_grads_of(march, rs, rd, net, tf, ray_grads=True, **kw):
    """(d ray_start, d ray_dir, {leaf: gradient}) of loss = mean(rgba^2)."""
    net.zero_grad(set_to_none=True)
    rs = rs.clone().requires_grad_(True)
    rd = rd.clone().requires_grad_(True)
    img = march(rs, rd, net, *BOX, tf, stepsize=1 / 128, differentiable=True,
                ray_grads=ray_grads, **kw)
    (img ** 2).mean().backward()
    torch.cuda.synchronize()
    return rs.grad, rd.grad, {n: p.grad.clone()
                              for n, p in net.named_parameters()}


@pytest.mark.parametrize("which", ["random", "flagship", "direction"])
@pytest.mark.parametrize("tile", [128, 256])
@pytest.mark.parametrize("table", ["bf16", "f32"])
def test_mega_ray_grads_match_plain(which, tile, table):
    """Row 3's ray-gradient instances: d ray_start and d ray_dir within a
    relative norm error of 1e-3 of the plain version's, or of NOISE_FLIP
    times the plain version's own change under an ulp of position noise
    (``position_noise``) where that is larger; the weights' gradients
    equal (1e-6 relative) to the same kernel pair's without the flag,
    which leaves the rays without a gradient."""
    needs_card()
    rs, rd, net, tf, clip = bench_case(
        "random" if which == "direction" else which, tile=tile)
    if which == "direction":
        net = random_net(direction=True, output_mode="density").cuda()
    kw = dict(tmax_clip=clip, tile=tile, enable_early_out=True,
              table_dtype=torch.bfloat16 if table == "bf16"
              else torch.float32)
    before = fused_mega.launches("mega_bwd")
    k_rs, k_rd, k_g = ray_grads_of(fused_mega.mega_trace_dvr, rs, rd, net,
                                   tf, **kw)
    p_rs, p_rd, _ = ray_grads_of(fused_mega.mega_trace_dvr_plain, rs, rd,
                                 net, tf, **kw)
    with position_noise():
        q_rs, q_rd, _ = ray_grads_of(fused_mega.mega_trace_dvr_plain, rs,
                                     rd, net, tf, **kw)
    floor = NOISE_FLIP * max(rel_err(q_rs, p_rs), rel_err(q_rd, p_rd))
    n_rs, n_rd, n_g = ray_grads_of(fused_mega.mega_trace_dvr, rs, rd, net,
                                   tf, ray_grads=False, **kw)
    assert fused_mega.launches("mega_bwd") == before + 2
    assert n_rs is None and n_rd is None
    tol = max(1e-3, floor)
    assert rel_err(k_rs, p_rs) <= tol and rel_err(k_rd, p_rd) <= tol, (
        rel_err(k_rs, p_rs), rel_err(k_rd, p_rd), floor)
    for name in n_g:
        if name == "latent.static_grid":   # atomics: another order a run
            assert rel_err(k_g[name], n_g[name]) <= 1e-5, name
        else:
            assert rel_err(k_g[name], n_g[name]) <= 1e-6, name


def test_mega_ray_grads_camera_matrix_matches_plain():
    """The camera matrix's gradient through generate_rays and row 3's
    ray-gradient instance, against the plain version (relative norm
    1e-3), on a 64x64 view of the flagship."""
    needs_card()
    from fvsrn_tpu_torch.camera import camera_matrix
    net = case_net("flagship")
    tf = dense_scene()[1].tensor.cuda()
    cam = CameraOnASphere.make(pitch=0.25, yaw=0.7, distance=1.6)
    got = []
    for march in (fused_mega.mega_trace_dvr, fused_mega.mega_trace_dvr_plain):
        m = camera_matrix(cam).cuda().requires_grad_(True)
        rs, rd = generate_rays(m, 64, 64, cam.fov_y_radians)
        perm, _ = block_ray_permutation(64, 64, 16, 16, device="cuda")
        img = march(rs.reshape(-1, 3)[perm], rd.reshape(-1, 3)[perm], net,
                    *BOX, tf, stepsize=1 / 128, differentiable=True,
                    ray_grads=True, enable_early_out=False)
        (img ** 2).mean().backward()
        torch.cuda.synchronize()
        got.append(m.grad)
    assert float(got[1].abs().max()) > 1e-4
    assert rel_err(got[0], got[1]) <= 1e-3


SEGMENT_CASES = {
    "flagship_bf16_table": dict(net="flagship", table_dtype=torch.bfloat16),
    "flagship_f32_table": dict(net="flagship"),
    "nogrid": dict(net=dict(channels=0)),
    "grid20_f32": dict(net=dict(channels=20)),
    "grid40_width48": dict(net=dict(channels=40, width=48)),
    "width64_relu": dict(net=dict(width=64, activation="ReLU")),
    "width20_sine": dict(net=dict(width=20, activation="Sine")),
    "softplus_density_head": dict(net=dict(activation="Softplus",
                                           output_mode="density")),
    "snake": dict(net=dict(activation="Snake")),
    "sigmoid": dict(net=dict(activation="Sigmoid")),
    "rgbo": dict(net=dict(output_mode="rgbo")),
    "rgbo_direct": dict(net=dict(output_mode="rgbo:direct")),
    "rgbo_exp": dict(net=dict(output_mode="rgbo:exp")),
    "direction": dict(net=dict(direction=True)),
    "thin_seg16": dict(net=dict(out_bias=0.0), kw=dict(seg=16)),
    "alpha_blend": dict(net={}, kw=dict(blend_mode="alpha")),
    "no_early_out": dict(net={}, kw=dict(enable_early_out=False)),
    "lattice_bf16": dict(net={}, table_dtype=torch.bfloat16,
                         kw=dict(latent_mode="boxfeat", tile=256)),
    "iso": dict(net=dict(output_mode="density"), kw=dict(iso_value=0.55)),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_kernel_matches_plain(case):
    """Row 4: the per-segment engine's kernel against its plain version on
    a 60x44 view padded to whole tiles: image, samples evaluated and
    the call's stop. Two launches a call, none by the plain version."""
    needs_card()
    spec = SEGMENT_CASES[case]
    _, tf, npz = dense_scene()
    net = (load_weights(npz) if spec["net"] == "flagship"
           else random_net(**spec["net"])).cuda()
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.8,
                                                distance=1.6),
                           60, 44, device="cuda")
    kw = dict(dict(stepsize=1 / 128, max_steps=222, seg=32, tile=128,
                   table_dtype=spec.get("table_dtype", torch.float32),
                   return_stats=True), **spec.get("kw", {}))
    rs, rd, _ = pad_rays(rs.reshape(-1, 3), rd.reshape(-1, 3), kw["tile"])
    args = (rs, rd, net, *BOX, tf.tensor.cuda())
    before = fused_dvr.SEGMENT_LAUNCHES
    got, stats = fused_dvr.fused_trace_dvr(*args, **kw)
    torch.cuda.synchronize()
    assert fused_dvr.SEGMENT_LAUNCHES == before + 2
    want, want_stats = fused_dvr.fused_trace_dvr_plain(*args, **kw)
    assert fused_dvr.SEGMENT_LAUNCHES == before + 2
    assert float(want[:, 3].max()) > 0.05
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert int(stats.samples) == int(want_stats.samples)
    assert int(stats.stop) == int(want_stats.stop)


@pytest.mark.parametrize("net_kw", [
    dict(width=160), dict(channels=80),
    dict(width=96, need_normals=True, tf_mode="texture"),
    dict(widths=[64, 32], differentiable=True)])
def test_segment_kernel_rejects_what_it_does_not_take(net_kw):
    """Hidden layers wider than 128, more than 64 latent channels,
    normals with a TF mode other than piecewise (above 64 wide too),
    several widths in training; it takes widths to 128, several widths
    in the render, and normals at every width."""
    tf = dense_scene()[1].tensor
    net_kw = dict(net_kw)
    kw = {k: net_kw.pop(k) for k in ("need_normals", "differentiable",
                                     "tf_mode") if k in net_kw}
    with pytest.raises(NotImplementedError):
        fused_dvr._check_kernel_inputs(random_net(**net_kw), tf, **kw)
    fused_dvr._check_kernel_inputs(random_net(width=64, channels=40), tf)
    fused_dvr._check_kernel_inputs(random_net(width=128), tf,
                                   differentiable=True)
    fused_dvr._check_kernel_inputs(random_net(widths=[64, 32]), tf)
    for kw in (dict(width=96), dict(width=128), dict(widths=[48, 96])):
        fused_dvr._check_kernel_inputs(random_net(**kw), tf,
                                       need_normals=True)


# the per-segment engine's differentiable pair over SEGMENT_CASES: a float32
# table (the bf16 cases train on float32), no iso march
SEGMENT_GRAD_CASES = sorted(set(SEGMENT_CASES) - {"iso"})
BF16_GRID_REL = 2.0 ** -7   # two bf16 ulps: one float32 sum rounded apart


def bf16_grid_close(got, want, floor=2e-4):
    """A bf16 table's gradient, the float32 sum rounded to bf16 once per
    cell, on the card and in the plain version: every element within
    2^-7 of its value (a sum summed in another order may round to the
    neighbouring bf16 value) plus ``floor`` of the leaf's largest (the
    float32 contract, for sums that cancel). Both are bf16 values."""
    assert torch.equal(got, got.to(torch.bfloat16).float())
    assert torch.equal(want, want.to(torch.bfloat16).float())
    bound = BF16_GRID_REL * want.abs() + floor * float(want.abs().max())
    assert bool(((got - want).abs() <= bound).all()), float(
        ((got - want).abs() - bound).max())


@pytest.mark.parametrize("case", SEGMENT_GRAD_CASES)
def test_segment_grad_kernel_matches_plain(case):
    """Rows 5-6: the image of the carry-storing forward and every gradient
    leaf of the backward against the plain differentiable pair, on a 60x44
    view padded to whole tiles: image <= 1e-4, each leaf within a relative
    norm error of 1e-3. One launch of each kernel, none by the plain
    pair."""
    needs_card()
    spec = SEGMENT_CASES[case]
    _, tf, npz = dense_scene()
    net = (load_weights(npz) if spec["net"] == "flagship"
           else random_net(**spec["net"])).cuda()
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.8,
                                                distance=1.6),
                           60, 44, device="cuda")
    kw = dict(dict(stepsize=1 / 128, max_steps=222, seg=32, tile=128),
              **spec.get("kw", {}), differentiable=True)
    if "table_dtype" in spec:
        kw["table_dtype"] = spec["table_dtype"]
    rs, rd, _ = pad_rays(rs.reshape(-1, 3), rd.reshape(-1, 3), kw["tile"])
    w = torch.empty(rs.shape[0], 4, device="cuda").uniform_(
        -1, 1, generator=torch.Generator("cuda").manual_seed(1))
    got = {}
    for fn in (fused_dvr.fused_trace_dvr, fused_dvr.fused_trace_dvr_plain):
        net.zero_grad(set_to_none=True)
        tf_leaf = tf.tensor.cuda().requires_grad_(True)
        before = (fused_dvr_bwd.launches("segment_fwd_diff"),
                  fused_dvr_bwd.launches("segment_bwd"))
        img = fn(rs, rd, net, *BOX, tf_leaf, **kw)
        (img * w).sum().backward()
        torch.cuda.synchronize()
        launched = (fused_dvr_bwd.launches("segment_fwd_diff") - before[0],
                    fused_dvr_bwd.launches("segment_bwd") - before[1])
        assert launched == ((1, 1) if fn is fused_dvr.fused_trace_dvr
                            else (0, 0))
        g = {n: p.grad.clone() for n, p in net.named_parameters()}
        if not net.output_mode.startswith("rgbo"):   # rgbo reads no TF
            g["tf"] = tf_leaf.grad.clone()
        got[fn] = (img.detach(), g)
    (img_k, g_k), (img_p, g_p) = got.values()
    assert float(img_p[:, 3].max()) > 0.05
    torch.testing.assert_close(img_k, img_p, rtol=0, atol=ATOL)
    assert sorted(g_k) == sorted(g_p)
    for name in g_p:
        if name == "latent.static_grid" and "table_dtype" in spec:
            bf16_grid_close(g_k[name], g_p[name])   # the bf16 table's
        else:
            assert rel_err(g_k[name], g_p[name]) <= 1e-3, name


def test_segment_grad_kernel_rejects_what_it_does_not_take():
    """The backward kernel takes segments of at most 32 samples."""
    tf = dense_scene()[1].tensor
    with pytest.raises(NotImplementedError):
        fused_dvr._check_kernel_inputs(random_net(), tf, seg=64,
                                       differentiable=True)
    fused_dvr._check_kernel_inputs(random_net(), tf, seg=64)
    fused_dvr._check_kernel_inputs(random_net(), tf, seg=32,
                                   differentiable=True)


SAMPLE_CASES = {
    "flagship_f32_table": dict(net="flagship"),
    "flagship_bf16_table": dict(net="flagship", table_dtype=torch.bfloat16),
    "nogrid_width64": dict(net=dict(channels=0, width=64)),
    "grid16_width48_sine": dict(net=dict(channels=16, width=48,
                                         activation="Sine")),
    "width20_relu": dict(net=dict(width=20, activation="ReLU")),
    "snake_density_head": dict(net=dict(activation="Snake",
                                        output_mode="density")),
    "direction": dict(net=dict(direction=True)),
}


KINK_EPS = 1e-5   # ten times the largest float32 error (against float64)
                  # of a ReLU net's pre-activation at these positions


def near_kink(net, pos01, dirs, table_dtype=torch.float32):
    """Positions at which the plain network's gradient has a kink within
    KINK_EPS: a ReLU unit's pre-activation within KINK_EPS of 0, the
    density clip's input within KINK_EPS of 0 or 1, or a latent grid
    coordinate within KINK_EPS (in cells) of a cell boundary. Float32
    noise may put such a position on either side of its kink in the
    kernel and in the plain version, and its gradient then differs by a
    finite amount. The network as fused_eval_plain evaluates it."""
    params = fused_dvr.segment_params(
        net, torch.tensor(fused_eval._NO_TF, device=pos01.device),
        table_dtype)
    fourier, grid, layers = params[1], params[2], params[3:]
    near = torch.zeros(pos01.shape[0], dtype=torch.bool,
                       device=pos01.device)
    feats = [pos01]
    if net.use_direction:
        feats.append(dirs)
    if fourier.shape[0]:
        xin = pos01 if fourier.shape[1] == 3 else torch.cat([pos01, dirs], 1)
        f = xin @ fourier.T
        feats += [torch.cos(f), torch.sin(f)]
    if grid is not None:
        feats.append(grid_sample_3d(grid, pos01))
        cells = pos01 * torch.tensor(grid.shape[:0:-1], device=pos01.device,
                                     dtype=pos01.dtype) - 0.5
        near |= ((cells - cells.round()).abs() < KINK_EPS).any(dim=1)
    y = torch.cat(feats, dim=1)
    name, p = net.layers[0].activation, net.layers[0].activation_param
    for i in range(len(layers) // 2 - 1):
        y = y @ layers[2 * i].T + layers[2 * i + 1]
        if name == "ReLU":
            near |= (y.abs() < KINK_EPS).any(dim=1)
        y = apply_activation(name, y, p)
    y = y @ layers[-2].T + layers[-1]
    if net.output_mode == "density:direct":
        near |= ((y.abs() < KINK_EPS) | ((y - 1.0).abs() < KINK_EPS)).any(
            dim=1)
    return near


def sample_eval_matches(net, pos, d, want_grad=False,
                        table_dtype=torch.float32):
    """The sample evaluator at positions ``pos`` (world, the box BOX) and
    directions ``d`` against its plain version: values <= 1e-4, the
    inside mask equal, and the position gradient within a relative norm
    error of 1e-3 on interior positions that lie no nearer than KINK_EPS
    to a kink of the plain network; every interior position whose
    gradient is off by more than 1e-2 of its size lies near a kink. One
    launch a call, none by the plain version."""
    ev = fused_eval.make_fused_eval(net, *BOX, table_dtype=table_dtype,
                                    want_grad=want_grad)
    before = fused_eval.SAMPLE_EVAL_LAUNCHES
    got = ev(pos, d)
    torch.cuda.synchronize()
    assert fused_eval.SAMPLE_EVAL_LAUNCHES == before + 1
    value, grad = fused_eval.fused_eval_plain(
        net, pos + 0.5, d if net.use_direction else None,
        want_grad=want_grad, table_dtype=table_dtype)
    assert fused_eval.SAMPLE_EVAL_LAUNCHES == before + 1
    assert torch.equal(got[1], ((pos >= -0.5) & (pos <= 0.5)).all(dim=1))
    torch.testing.assert_close(got[0], value, rtol=0, atol=ATOL)
    if want_grad:
        inner = (pos.abs() < 0.45).all(dim=1)
        kinks = near_kink(net, pos + 0.5,
                          d if net.use_direction else torch.zeros_like(pos),
                          table_dtype)
        size = grad.norm(dim=1)
        rms = float(size[inner].square().mean().sqrt()) if inner.any() else 0.0
        err = (got[2] - grad).norm(dim=1)
        off = inner & (err > 1e-2 * size.clamp(min=max(rms, 1e-6)))
        print(f"{int((inner & kinks).sum())} of {int(inner.sum())} interior "
              f"positions within {KINK_EPS} of a kink left out, "
              f"{int(off.sum())} positions off")
        assert not bool((off & ~kinks).any())
        keep = inner & ~kinks
        g_k, g_p = got[2][keep], grad[keep]
        if float(g_p.norm()) > 0:
            assert rel_err(g_k, g_p) <= 1e-3
        else:   # no interior position, or every one clipped
            assert float(g_k.norm()) == 0.0


@pytest.mark.parametrize("n", [1, 31, 33, 5000, 2 ** 18 + 7])
@pytest.mark.parametrize("want_grad", [False, True])
@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sample_eval_kernel_matches_plain(case, want_grad, n):
    """Row 7: the sample evaluator against its plain version on n
    positions with 20% spill past the box and unit directions: one
    position, part of a tile (31), a tile and one row (33), 5000, and a
    launch larger than the persistent grid's resident tiles (2^18 + 7)."""
    needs_card()
    spec = SAMPLE_CASES[case]
    _, _, npz = dense_scene()
    net = (load_weights(npz) if spec["net"] == "flagship"
           else random_net(**spec["net"])).cuda()
    gen = torch.Generator("cuda").manual_seed(0)
    pos = torch.rand(n, 3, device="cuda", generator=gen) * 1.4 - 0.7
    d = torch.randn(n, 3, device="cuda", generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    sample_eval_matches(net, pos, d, want_grad,
                        spec.get("table_dtype", torch.float32))


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_sample_eval_path_like_positions(table_dtype):
    """Row 7 on positions as Monte-Carlo tracking gives them: one a pixel
    ray of a 160x120 view in pixel order, at a random t along the ray
    (neighbouring lanes on neighbouring rays, some past the box)."""
    needs_card()
    net = load_weights(dense_scene()[2]).cuda()
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.5,
                                                distance=1.6),
                           160, 120, device="cuda")
    rs, rd = rs.reshape(-1, 3), rd.reshape(-1, 3)
    gen = torch.Generator("cuda").manual_seed(1)
    t = 0.9 + 1.4 * torch.rand(rs.shape[0], 1, device="cuda", generator=gen)
    sample_eval_matches(net, (rs + t * rd).contiguous(), rd,
                        table_dtype=table_dtype)


@pytest.mark.parametrize("hidden", [32, 48, 64, 128])
def test_sample_eval_plan_and_grid_match_device(hidden):
    """The value instance's shared-memory plan and persistent grid on the
    device equal fused_eval.eval_plan and sample_mlp.persistent_blocks,
    for call sizes below, at and above the resident grid."""
    needs_card()
    from fvsrn_tpu_torch.ops import sample_mlp
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for nf, chunks, nh, direction in ((14, 1, 2, False), (32, 1, 6, True),
                                      (0, 0, 0, False)):
        plan = fused_eval.eval_plan(hidden, nf, chunks, nh, direction)
        for n in (0, 1, 33, 5000, 2 ** 18 + 7):
            assert fused_eval.device_eval_grid(
                n, hidden, nf, chunks, nh, direction) == (
                    plan.bytes, plan.warps, plan.pre,
                    sample_mlp.persistent_blocks(n, plan, sms), sms)


# ---------------------------------------------------------------------------
# the redesigned training backwards (csrc/sample_mlp.cuh): compaction edges,
# widths, Fourier counts, determinism

SEG_GRAD_KW = dict(stepsize=1 / 128, max_steps=222, seg=32, tile=128)
OPAQUE_TF = dict(rgb=[[0.9, 0.1, 0.1], [0.1, 0.9, 0.1], [0.1, 0.1, 0.9]],
                 opacity=[2.0, 10.0, 30.0], positions=[0.0, 0.45, 1.0])


def segment_grads_match(net, rs, rd, tf, **kw):
    """The scan engine's kernel pair against its plain pair on the same
    rays: image <= 1e-4 and every gradient leaf of sum(w * rgba), w
    seeded, within a relative norm error of 1e-3."""
    kw = dict(SEG_GRAD_KW, **kw, differentiable=True)
    w = torch.empty(rs.shape[0], 4, device="cuda").uniform_(
        -1, 1, generator=torch.Generator("cuda").manual_seed(1))
    got = []
    for fn in (fused_dvr.fused_trace_dvr, fused_dvr.fused_trace_dvr_plain):
        net.zero_grad(set_to_none=True)
        tf_leaf = tf.cuda().requires_grad_(True)
        img = fn(rs, rd, net, *BOX, tf_leaf, **kw)
        (img * w).sum().backward()
        torch.cuda.synchronize()
        g = {n: p.grad.clone() for n, p in net.named_parameters()}
        if not net.output_mode.startswith("rgbo"):
            g["tf"] = tf_leaf.grad.clone()
        got.append((img.detach(), g))
    (img_k, g_k), (img_p, g_p) = got
    torch.testing.assert_close(img_k, img_p, rtol=0, atol=ATOL)
    assert sorted(g_k) == sorted(g_p)
    for name in g_p:
        assert g_k[name].shape == g_p[name].shape, name
        if g_p[name].numel():      # no Fourier feature: an empty matrix
            assert rel_err(g_k[name], g_p[name]) <= 1e-3, name


def segment_bwd_direct(net, rs, rd, tf, partial_rows=False, **kw):
    """One launch of each kernel of the pair through their wrappers:
    (backward's gradient or partial rows, table gradient, [replayed,
    contributing], valid samples of the forward)."""
    kw = dict(SEG_GRAD_KW, **kw)
    spec, rays, kbase = fused_dvr._segment_setup(
        rs, rd, net, *BOX, density_min=0.0, density_max=1.0,
        blend_mode="beer_lambert", alpha_early_out=0.999, seg=kw["seg"],
        tile=kw["tile"], differentiable=True, latent_mode="table",
        table_dtype=torch.float32, n_seg=None, need_normals=False,
        iso_value=None, tf_mode="piecewise", tmax_clip=None,
        stepsize=kw["stepsize"], max_steps=kw["max_steps"],
        enable_early_out=False)
    tf = tf.cuda()
    weights = fused_dvr.pack_segment_weights(net, tf)
    table = fused_dvr.segment_table(net, torch.float32, rs.device)
    out, st, carries, death = fused_dvr.launch_segment(
        spec, net, rays, kbase, weights, table, tf.shape[0],
        store_carries=True)
    d_out = 2.0 * out / out.numel()
    dw, d_table, work = fused_dvr_bwd.launch_segment_bwd(
        spec, net, rays, kbase, weights, table, carries, death, d_out,
        tf.shape[0], partial_rows=partial_rows)
    torch.cuda.synchronize()
    return dw, d_table, work.tolist(), int(st.samples)


def test_segment_bwd_every_sample_contributes():
    """Parallel rays through the whole box, a sigmoid density head and a
    TF that absorbs everywhere: every valid sample contributes, so each
    segment's tiles are full."""
    needs_card()
    net = random_net(output_mode="density").cuda()
    tf = TransferFunctionPiecewiseLinear.make(**OPAQUE_TF).tensor
    g = torch.linspace(-0.45, 0.45, 16, device="cuda")
    xy = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    rs = torch.cat([xy, torch.full_like(xy[:, :1], -1.0)], 1).contiguous()
    rd = torch.zeros_like(rs)
    rd[:, 2] = 1.0
    _, _, work, n_valid = segment_bwd_direct(net, rs, rd, tf)
    assert work == [n_valid, n_valid] and n_valid >= 256 * 128
    segment_grads_match(net, rs, rd, tf)


def test_segment_bwd_one_contributing_sample():
    """A block where one ray grazes the box's edge (a chord shorter than a
    step: one sample) and every other ray misses it: the compaction's
    edge, one row in one tile of one group."""
    needs_card()
    net = random_net(output_mode="density").cuda()
    tf = TransferFunctionPiecewiseLinear.make(**OPAQUE_TF).tensor
    rs = torch.tensor([[2.0, 2.0, 2.0]], device="cuda").repeat(128, 1)
    rd = torch.tensor([[1.0, 0.0, 0.0]], device="cuda").repeat(128, 1)
    rs[37] = torch.tensor([0.498, -0.501, 0.1])
    rd[37] = torch.tensor([1.0, 1.0, 0.0]) / math.sqrt(2.0)
    dw, _, work, n_valid = segment_bwd_direct(net, rs, rd, tf)
    assert n_valid == 1 and work == [1, 1]
    assert float(dw.abs().max()) > 0
    segment_grads_match(net, rs, rd, tf)


def test_segment_bwd_ray_count_off_the_block():
    """1000 rays: a multiple of neither the block's 64 rays nor a tile."""
    needs_card()
    net = random_net().cuda()
    tf = dense_scene()[1].tensor
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.8,
                                                distance=1.6),
                           40, 25, device="cuda")
    segment_grads_match(net, rs.reshape(-1, 3).contiguous(),
                        rd.reshape(-1, 3).contiguous(), tf, tile=8)


@pytest.mark.parametrize("fourier", [0, 32])
@pytest.mark.parametrize("width", [32, 48, 64])
def test_segment_bwd_widths_and_fourier(width, fourier):
    """Each hidden width's instance with no Fourier feature and with the
    kernels' largest count."""
    needs_card()
    net = random_net(width=width, fourier=fourier).cuda()
    tf = dense_scene()[1].tensor
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.8,
                                                distance=1.6),
                           60, 44, device="cuda")
    rs, rd, _ = pad_rays(rs.reshape(-1, 3), rd.reshape(-1, 3), 128)
    segment_grads_match(net, rs, rd, tf)


def test_segment_bwd_deterministic():
    """Two launches give bitwise-equal partial rows: every weight-gradient
    entry of a block is owned by one thread."""
    needs_card()
    net = random_net(direction=True).cuda()
    tf = dense_scene()[1].tensor
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.8,
                                                distance=1.6),
                           60, 44, device="cuda")
    rs, rd, _ = pad_rays(rs.reshape(-1, 3), rd.reshape(-1, 3), 128)
    a = segment_bwd_direct(net, rs, rd, tf, partial_rows=True)
    b = segment_bwd_direct(net, rs, rd, tf, partial_rows=True)
    assert a[0].shape[0] == -(-rs.shape[0] // 64)
    assert float(a[0].abs().max()) > 0
    assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("hidden", [32, 48, 64, 128])
def test_segment_bwd_smem_plan_matches_device(hidden):
    """The device's shared-memory plan equals ops.sample_mlp's mirror at
    the flagship's widths and at the kernels' largest limits."""
    needs_card()
    from fvsrn_tpu_torch.ops import sample_mlp
    for nf, chunks, nh, tp in ((14, 1, 2, 8), (32, 4, 6, 16)):
        plan = sample_mlp.smem_plan(hidden, 6 + 2 * nf + 16 * chunks, nh, nf,
                                    tp)
        assert fused_dvr_bwd.device_smem_plan(hidden, nf, chunks, nh, tp) \
            == (plan.bytes, plan.tile_rows, plan.pad)


@pytest.mark.parametrize("fourier", [0, 32])
def test_mega_backward_fourier_counts(fourier):
    """Row 3 with no Fourier feature and with the kernels' largest count:
    every gradient leaf within a relative norm error of 1e-3."""
    needs_card()
    net = random_net(fourier=fourier).cuda()
    got, want = kernel_and_plain_grads(*diff_case("random", True, net=net))
    for name in want:
        assert got[name].shape == want[name].shape, name
        if want[name].numel():
            assert rel_err(got[name], want[name]) <= 1e-3, name


def test_mega_backward_deterministic():
    """Two launches of row 3 give bitwise-equal partial rows."""
    needs_card()
    net, tf, rays, spec = diff_case("random", True)
    params = fused_mega._params(net, tf)
    widths = fused_mega._widths(params)
    weights = fused_mega._pack_weights(params, spec)
    table = fused_mega._kernel_table(params[2], torch.float32, rays.device)
    fwd = fused_mega._launch_fwd(rays, weights, table, spec, *widths[:3],
                                 n_seg_max=fused_mega.segments_needed(rays,
                                                                      spec))
    d_out = 2.0 * fwd[0] / fwd[0].numel()
    rows = [fused_mega._launch_bwd(rays, weights, table, fwd[2], fwd[3],
                                   d_out, spec, *widths,
                                   partial_rows=True)[0] for _ in range(2)]
    torch.cuda.synchronize()
    assert rows[0].shape[0] == rays.shape[0] // 256
    assert float(rows[0].abs().max()) > 0
    assert torch.equal(rows[0], rows[1])


# ---------------------------------------------------------------------------
# the redesigned forwards (csrc/warp_mlp.cuh): list and tile edges, the
# call's stop, iso, widths, tables, determinism, the shared-memory plan

SEG_FWD_KW = dict(stepsize=1 / 128, max_steps=222, seg=32, tile=128)


def segment_fwd_matches(net, rs, rd, tf, **kw):
    """The per-segment render kernel against its plain version on the same
    rays: image <= 1e-4, samples and the call's stop equal. Returns the
    kernel's (image, stats)."""
    kw = dict(SEG_FWD_KW, **kw, return_stats=True)
    args = (rs, rd, net, *BOX, tf.cuda())
    got, st = fused_dvr.fused_trace_dvr(*args, **kw)
    torch.cuda.synchronize()
    want, st_p = fused_dvr.fused_trace_dvr_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert int(st.samples) == int(st_p.samples)
    assert int(st.stop) == int(st_p.stop)
    return got, st


def segment_fwd_direct(net, rs, rd, tf, **kw):
    """Both launches of csrc/segment_fwd.cu through launch_segment:
    (image, stats, death)."""
    kw = dict(SEG_FWD_KW, **kw)
    spec, rays, kbase = fused_dvr._segment_setup(
        rs, rd, net, *BOX, density_min=0.0, density_max=1.0,
        blend_mode="beer_lambert", alpha_early_out=0.999, seg=kw["seg"],
        tile=kw["tile"], differentiable=False, latent_mode="table",
        table_dtype=torch.float32, n_seg=None, need_normals=False,
        iso_value=None, tf_mode="piecewise", tmax_clip=None,
        stepsize=kw["stepsize"], max_steps=kw["max_steps"],
        enable_early_out=True)
    tf = tf.cuda()
    out, st, _, death = fused_dvr.launch_segment(
        spec, net, rays, kbase, fused_dvr.pack_segment_weights(net, tf),
        fused_dvr.segment_table(net, torch.float32, rs.device), tf.shape[0])
    torch.cuda.synchronize()
    return out, st, death


def view_rays(width=60, height=44, tile=128, yaw=0.8):
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=yaw,
                                                distance=1.6),
                           width, height, device="cuda")
    rs, rd, _ = pad_rays(rs.reshape(-1, 3), rd.reshape(-1, 3), tile)
    return rs, rd


def test_segment_fwd_rows_straddle_tiles():
    """Rays from one plane fanned out in x: each crosses the box on a chord
    of another length, so its valid samples in its last segments are a
    different count and its rows start and end inside the tiles of its
    warp's list (the carry crosses tile boundaries)."""
    needs_card()
    net = random_net(output_mode="density").cuda()
    tf = TransferFunctionPiecewiseLinear.make(**OPAQUE_TF).tensor
    n = 128
    rs = torch.zeros(n, 3, device="cuda")
    rs[:, 0] = torch.linspace(-0.4, 0.4, n, device="cuda")
    rs[:, 1] = 0.1
    rs[:, 2] = -1.0
    rd = torch.zeros_like(rs)
    rd[:, 0] = torch.linspace(-0.45, 0.45, n, device="cuda")
    rd[:, 2] = 1.0
    rd = rd / rd.norm(dim=1, keepdim=True)
    _, st = segment_fwd_matches(net, rs, rd, tf, enable_early_out=False)
    assert int(st.samples) > 32 * n


def test_segment_fwd_one_live_ray_in_a_warp():
    """A warp where one ray crosses the box and the other 31 miss it: the
    warp's tiles are that ray's samples alone."""
    needs_card()
    net = random_net().cuda()
    tf = dense_scene()[1].tensor
    rs = torch.tensor([[2.0, 2.0, 2.0]], device="cuda").repeat(128, 1)
    rd = torch.tensor([[1.0, 0.0, 0.0]], device="cuda").repeat(128, 1)
    rs[37] = torch.tensor([-0.3, 0.1, -1.0])
    rd[37] = torch.tensor([0.2, 0.1, 1.0]) / math.sqrt(1.05)
    _, st = segment_fwd_matches(net, rs, rd, tf)
    assert int(st.samples) > 64


def test_segment_fwd_phase1_continuation():
    """Rays that saturate early and die before the call's stop S composite
    their segments up to S in the second launch: the image, samples and S
    against the plain version."""
    needs_card()
    _, tf, npz = dense_scene()
    net = load_weights(npz).cuda()
    tf = tf.tensor
    rs, rd = view_rays()
    out, st, death = segment_fwd_direct(net, rs, rd, tf)
    continued = (death < int(st.stop)) & (out[:, 3] >= 0.999)
    assert int(continued.sum()) > 0
    segment_fwd_matches(net, rs, rd, tf)


def test_segment_fwd_iso_hits_inside_tiles():
    """The iso march at a fine step: first hits fall at every position of
    a segment and of a tile; samples are counted up to each ray's hit."""
    needs_card()
    net = random_net(output_mode="density").cuda()
    tf = dense_scene()[1].tensor
    rs, rd = view_rays()
    got, _ = segment_fwd_matches(net, rs, rd, tf, stepsize=1 / 256,
                                 max_steps=444, iso_value=0.55)
    hit = got[:, 3] > 0.5
    assert 0.05 < float(hit.float().mean()) < 0.95


def test_segment_fwd_ray_count_off_the_block():
    """1000 rays: a multiple of neither a warp's 32 rays nor the block."""
    needs_card()
    net = random_net().cuda()
    tf = dense_scene()[1].tensor
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.8,
                                                distance=1.6),
                           40, 25, device="cuda")
    segment_fwd_matches(net, rs.reshape(-1, 3).contiguous(),
                        rd.reshape(-1, 3).contiguous(), tf, tile=8)


@pytest.mark.parametrize("table", ["c16_bf16", "c16_f32", "c64_f32"])
@pytest.mark.parametrize("fourier", [0, 32])
@pytest.mark.parametrize("width", [32, 48, 64])
def test_segment_fwd_widths_fourier_tables(width, fourier, table):
    """Each hidden width's instance with no Fourier feature and with the
    largest count, one latent row as a bf16 or float32 table and four
    rows (float32)."""
    needs_card()
    channels = 64 if table == "c64_f32" else 16
    net = random_net(width=width, fourier=fourier, channels=channels).cuda()
    dtype = torch.bfloat16 if table == "c16_bf16" else torch.float32
    rs, rd = view_rays()
    segment_fwd_matches(net, rs, rd, dense_scene()[1].tensor,
                        table_dtype=dtype)


def test_segment_fwd_deterministic():
    """Two launches give bitwise-equal images and stats."""
    needs_card()
    net = random_net(direction=True).cuda()
    tf = dense_scene()[1].tensor
    rs, rd = view_rays()
    a = segment_fwd_direct(net, rs, rd, tf)
    b = segment_fwd_direct(net, rs, rd, tf)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert int(a[1].samples) == int(b[1].samples)


@pytest.mark.parametrize("fourier", [0, 32])
@pytest.mark.parametrize("table", [torch.bfloat16, torch.float32])
def test_mega_fwd_fourier_and_tables(fourier, table):
    """Row 1 with no Fourier feature and with the largest count, on a bf16
    and a float32 table: image and samples against the plain version."""
    needs_card()
    net = random_net(fourier=fourier).cuda()
    rs, rd = block_rays(64, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    kw = dict(stepsize=1 / 128, tmax_clip=clip, return_samples=True,
              table_dtype=table)
    args = (rs, rd, net, *BOX, dense_scene()[1].tensor.cuda())
    got, samples = fused_mega.mega_trace_dvr(*args, **kw)
    want, samples_plain = fused_mega.mega_trace_dvr_plain(*args, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert torch.equal(samples.long(), samples_plain)


def test_mega_fwd_deterministic():
    """Two launches of row 2 give bitwise-equal images, carries, samples
    and segment counts."""
    needs_card()
    net, tf, rays, spec = diff_case("random", True)
    params = fused_mega._params(net, tf)
    widths = fused_mega._widths(params)
    weights = fused_mega._pack_weights(params, spec)
    table = fused_mega._kernel_table(params[2], torch.float32, rays.device)
    n_seg = fused_mega.segments_needed(rays, spec)
    runs = [fused_mega._launch_fwd(rays, weights, table, spec, *widths[:3],
                                   n_seg_max=n_seg) for _ in range(2)]
    torch.cuda.synchronize()
    (out, samples, carries, count), b = runs
    assert torch.equal(out, b[0]) and torch.equal(samples, b[1])
    assert torch.equal(count, b[3])
    for t in range(count.shape[0]):   # the segments each tile visited
        assert torch.equal(carries[t, :int(count[t])],
                           b[2][t, :int(count[t])])


@pytest.mark.parametrize("hidden", [32, 48, 64, 128])
def test_forward_smem_plans_match_device(hidden):
    """The forwards' shared-memory plans on the device equal
    ops.sample_mlp's mirror at the flagship's widths and at the kernels'
    largest limits."""
    needs_card()
    from fvsrn_tpu_torch.ops import sample_mlp
    for nf, chunks, nh, tp in ((14, 1, 2, 8), (32, 4, 6, 16)):
        for direction in (False, True):
            plan = sample_mlp.fwd_plan(hidden, nf, chunks, nh, tp,
                                       direction=direction)
            assert fused_dvr.device_fwd_plan(
                hidden, nf, chunks, nh, tp, direction) == (
                    plan.bytes, plan.warps, plan.pre)
    for nf, nh, tp in ((14, 2, 8), (32, 6, 16), (0, 0, 2)):
        for direction in (False, True):
            plan = sample_mlp.fwd_plan(hidden, nf, 1, nh, tp, warps=8,
                                       direction=direction)
            got = fused_mega.device_fwd_plan(nf, nh, tp, hidden=hidden,
                                             direction=direction)
            assert got == (None if plan is None
                           else (plan.bytes, 8, plan.pre))


# ---------------------------------------------------------------------------
# the TF modes (texture, 1D- and 2D-preintegrated, Gaussians) in rows 1-6


TF_MODES = ("texture", "preint1d", "preint2d", "gaussian")
# The 1D preintegration's near branch (|d - prev| < 1e-3) and the 2D
# table's nearest cell are discontinuous in the density: where the
# kernel's TF32 three-pass products and the plain version's float32 ones
# round a density (~1e-6 apart) to the two sides of an edge, the sample
# takes the other branch or cell, and its adjoint differs whole (the near
# branch's 1/(d - prev) factors are ~1e3). Those modes hold the share of
# rays off by more than ATOL, and how far off they are, instead of every
# ray, and each gradient leaf to FLIP_GRAD times the plain version's
# largest own change when every weight moves by a seeded relative
# FLIP_EPS (a density noise of the two versions' size; a uniform shift
# of every density would move no d - prev), over FLIP_SEEDS seeds: one
# flipped sample can move a leaf by 1e-3, and the moves are heavy-tailed
# (at 64x64, h = 1/64, five seeds moved the 1D table's gradient by
# 5.3e-5 to 1.5e-3).
FLIP_SHARE = 0.01           # the renders'
FLIP_SHARE_DIFF = 0.0025    # the differentiable pairs', at least
FLIP_ATOL = 0.05
FLIP_GRAD = 2.0
FLIP_EPS = 1e-6
FLIP_SEEDS = 4


def flip_bounds(mode, plain_march, args, kw, tf, tf_kw, img, want):
    """(share of rays off ATOL, {leaf: relative error}) that the kernel's
    image and gradients may reach against the plain ones (``img``,
    ``want``): FLIP_SHARE and 1e-3; in the preintegrating modes the
    larger of FLIP_SHARE_DIFF and 1e-3 and FLIP_GRAD times the plain
    version's largest own change when every weight moves by a relative
    FLIP_EPS, over FLIP_SEEDS seeds."""
    tols = {n: 1e-3 for n in want}
    if mode not in ("preint1d", "preint2d"):
        return FLIP_SHARE, tols
    import copy
    share = FLIP_SHARE_DIFF
    for seed in range(FLIP_SEEDS):
        moved = copy.deepcopy(args[2])
        gen = torch.Generator(moved.layers[0].weight.device).manual_seed(seed)
        with torch.no_grad():
            for p in moved.parameters():
                p.mul_(1.0 + FLIP_EPS * torch.randn(
                    p.shape, device=p.device, generator=gen))
        img_q, got = tf_grads(plain_march, args[:2] + (moved,) + args[3:],
                              kw, tf, tf_kw)
        off = float(((img_q - img).abs().amax(dim=-1) > ATOL).float().mean())
        share = max(share, FLIP_GRAD * off)
        for n in want:
            if float(want[n].norm()) > 0:
                tols[n] = max(tols[n], FLIP_GRAD * rel_err(got[n], want[n]))
    return share, tols


def assert_image_close(got, want, mode, share=FLIP_SHARE):
    if mode not in ("preint1d", "preint2d"):
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        return
    err = (got - want).abs().amax(dim=-1)
    assert float((err > ATOL).float().mean()) <= share
    assert float(err.max()) <= FLIP_ATOL


def tf_mode_args(mode, h):
    """(tf tensor, {tf_mode, tf_pre}) of the flagship's ramp TF in
    ``mode`` on the card (``scenes.dense_tf_modes``)."""
    from fvsrn_tpu_torch.scenes import dense_tf_modes
    tensor, kw = fused_dvr.fused_tf_args(dense_tf_modes(h)[mode])
    kw = {k: (v.cuda() if torch.is_tensor(v) else v) for k, v in kw.items()}
    return tensor.cuda(), kw


def tf_grads(march, args, kw, tf, tf_kw):
    """Image and every gradient leaf (the network's, "tf" and "pre") of
    loss = sum(img^2) through ``march``."""
    net = args[2]
    net.zero_grad(set_to_none=True)
    tf_leaf = tf.clone().requires_grad_(True)
    pre = tf_kw.get("tf_pre")
    pre_leaf = pre.clone().requires_grad_(True) if pre is not None else None
    kw2 = dict(tf_kw, tf_pre=pre_leaf) if pre is not None else tf_kw
    img = march(*args[:5], tf_leaf, **kw, **kw2)
    (img ** 2).sum().backward()
    torch.cuda.synchronize()
    g = {n: p.grad.clone() for n, p in net.named_parameters()
         if p.grad is not None}
    for name, leaf in (("tf", tf_leaf), ("pre", pre_leaf)):
        if leaf is not None and leaf.grad is not None:
            g[name] = leaf.grad.clone()
    return img.detach(), g


@pytest.mark.parametrize("mode", TF_MODES)
@pytest.mark.parametrize("which", ["random", "flagship", "width64"])
def test_tf_mode_mega_matches_plain(mode, which):
    """Rows 1-3 in each TF mode: the render (bf16 table), and the
    differentiable pair's image and every gradient leaf (the TF's
    tables too) against the plain versions, the tile vote on."""
    needs_card()
    net = case_net(which)
    rs, rd = block_rays(64, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    h = 1 / 128
    tf, tf_kw = tf_mode_args(mode, h)
    kw = dict(stepsize=h, tmax_clip=clip)
    before = fused_mega.launches("mega_fwd")
    with torch.no_grad():
        got = fused_mega.mega_trace_dvr(rs, rd, net, *BOX, tf, **kw, **tf_kw)
        want = fused_mega.mega_trace_dvr_plain(rs, rd, net, *BOX, tf, **kw,
                                               **tf_kw)
    assert fused_mega.launches("mega_fwd") == before + 1
    assert float(want[:, 3].max()) > 0.5
    assert_image_close(got, want, mode)
    args = (rs, rd, net, *BOX)
    kw = dict(kw, differentiable=True)
    before = (fused_mega.launches("mega_fwd_diff"),
              fused_mega.launches("mega_bwd"))
    img, got = tf_grads(fused_mega.mega_trace_dvr, args, kw, tf, tf_kw)
    assert (fused_mega.launches("mega_fwd_diff"),
            fused_mega.launches("mega_bwd")) == (before[0] + 1,
                                                 before[1] + 1)
    img_plain, want = tf_grads(fused_mega.mega_trace_dvr_plain, args, kw,
                               tf, tf_kw)
    share, tols = flip_bounds(mode, fused_mega.mega_trace_dvr_plain, args,
                              kw, tf, tf_kw, img_plain, want)
    assert_image_close(img, img_plain, mode, share)
    assert sorted(got) == sorted(want)
    for name in want:
        if mode == "preint2d" and name not in ("pre",):
            assert float(got[name].abs().max()) == 0.0, name
            continue
        assert rel_err(got[name], want[name]) <= tols[name], name


@pytest.mark.parametrize("mode", TF_MODES)
@pytest.mark.parametrize("lattice", [False, True])
def test_tf_mode_segment_matches_plain(mode, lattice):
    """Rows 4-6 in each TF mode: the render (both launches, the call's
    stop; per-ray sampling or the lattice) and the differentiable pair's
    image and every gradient leaf against the plain versions."""
    needs_card()
    net = case_net("random")
    rs, rd = block_rays(64, "cuda")
    h = 1 / 64
    tf, tf_kw = tf_mode_args(mode, h)
    kw = dict(stepsize=h, max_steps=112, seg=32, tile=128,
              latent_mode="boxfeat" if lattice else "table")
    before = fused_dvr.SEGMENT_LAUNCHES
    with torch.no_grad():
        got, st = fused_dvr.fused_trace_dvr(rs, rd, net, *BOX, tf,
                                            return_stats=True, **kw, **tf_kw)
        want, st_plain = fused_dvr.fused_trace_dvr_plain(
            rs, rd, net, *BOX, tf, return_stats=True, **kw, **tf_kw)
    assert fused_dvr.SEGMENT_LAUNCHES == before + 2
    assert float(want[:, 3].max()) > 0.5
    assert_image_close(got, want, mode)
    assert int(st.stop) == int(st_plain.stop)
    args = (rs, rd, net, *BOX)
    kw = dict(kw, differentiable=True, max_steps=112)
    before = (fused_dvr_bwd.launches("segment_fwd_diff"),
              fused_dvr_bwd.launches("segment_bwd"))
    img, got = tf_grads(fused_dvr.fused_trace_dvr, args, kw, tf, tf_kw)
    assert (fused_dvr_bwd.launches("segment_fwd_diff"),
            fused_dvr_bwd.launches("segment_bwd")) == (before[0] + 1,
                                                    before[1] + 1)
    img_plain, want = tf_grads(fused_dvr.fused_trace_dvr_plain, args, kw,
                               tf, tf_kw)
    share, tols = flip_bounds(mode, fused_dvr.fused_trace_dvr_plain, args,
                              kw, tf, tf_kw, img_plain, want)
    assert_image_close(img, img_plain, mode, share)
    for name in want:
        if mode == "preint2d" and name != "pre":
            assert name not in got or float(got[name].abs().max()) == 0.0
            continue
        assert rel_err(got[name], want[name]) <= tols[name], name


# the texture and preintegrated TFs on every other network: the render's
# forwards of rows 1 and 4 (csrc/mega_fwd_anytf*.cu, MEGA_PART 3, and
# csrc/segment_fwd_anytf.cu, SEGMENT_TF_MODES 2: the generic activation
# switch, direction input read)
ANYTF_MODES = ("texture", "preint1d", "preint2d")
ANYTF_NETS = {
    "relu_dir": dict(activation="ReLU", direction=True),
    "softplus": dict(activation="Softplus"),
    "sine30": dict(activation="Sine", act_param=30.0),
    "relu_dir48": dict(activation="ReLU", direction=True, width=48),
    "sine64": dict(activation="Sine", act_param=30.0, width=64),
}
# Sine:30's 30x pre-activations carry float32 noise far: one ulp of weight
# noise moves the plain version's own image by up to ~1e-3 and flips a
# share of the preintegrated modes' branches (chip_smoke.py flip_share).
# The kernel is held to ANYTF_FLIP times the plain version's own change
# under a seeded relative ANYTF_NOISE in every weight, and to ATOL and
# FLIP_SHARE at least.
ANYTF_NOISE = 1e-7
ANYTF_FLIP = 5.0


def assert_within_noise(got, want, plain, args, kw, mode):
    """``got`` (the kernel's image) against ``want`` (the plain version's)
    within ANYTF_FLIP times the plain version's own change when its
    network's weights move by a relative ANYTF_NOISE: every ray within
    that change's largest (ATOL at least), or in the preintegrated modes
    its share of rays off ATOL (FLIP_SHARE at least) within FLIP_ATOL."""
    moved = copy.deepcopy(args[2])
    gen = torch.Generator("cuda").manual_seed(0)
    with torch.no_grad():
        for p in moved.parameters():
            p.mul_(1.0 + ANYTF_NOISE * torch.randn(p.shape, device="cuda",
                                                   generator=gen))
        noisy = plain(*args[:2], moved, *args[3:], **kw)
    own = (noisy - want).abs().amax(dim=-1)
    err = (got - want).abs().amax(dim=-1)
    if mode in ("preint1d", "preint2d"):
        share = max(FLIP_SHARE,
                    ANYTF_FLIP * float((own > ATOL).float().mean()))
        assert float((err > ATOL).float().mean()) <= share
        assert float(err.max()) <= FLIP_ATOL
    else:
        assert float(err.max()) <= max(ATOL, ANYTF_FLIP * float(own.max()))


@pytest.mark.parametrize("mode", ANYTF_MODES)
@pytest.mark.parametrize("which", sorted(ANYTF_NETS))
def test_anytf_mega_matches_plain(mode, which):
    """Row 1 in each texture mode on a network other than SnakeAlt
    without direction input: one launch of the width's mega_fwd_anytf
    library, against the plain version (bf16 table, tile vote on; within
    the plain version's own noise, ``assert_within_noise``)."""
    needs_card()
    net = random_net(**ANYTF_NETS[which]).cuda()
    rs, rd = block_rays(64, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    h = 1 / 128
    tf, tf_kw = tf_mode_args(mode, h)
    kw = dict(stepsize=h, tmax_clip=clip)
    width = fused_mega.kernel_width(net)
    lib = "mega_fwd_anytf" + ("" if width == 32 else str(width))
    before = fused_mega.LIBRARY_LAUNCHES[lib]
    with torch.no_grad():
        got = fused_mega.mega_trace_dvr(rs, rd, net, *BOX, tf, **kw, **tf_kw)
        want = fused_mega.mega_trace_dvr_plain(rs, rd, net, *BOX, tf, **kw,
                                               **tf_kw)
    torch.cuda.synchronize()
    assert fused_mega.LIBRARY_LAUNCHES[lib] == before + 1
    assert float(want[:, 3].max()) > 0.5
    assert_within_noise(got, want, fused_mega.mega_trace_dvr_plain,
                        (rs, rd, net, *BOX, tf), dict(kw, **tf_kw), mode)
    gauss, g_kw = tf_mode_args("gaussian", h)
    with pytest.raises(NotImplementedError, match="gaussian"):
        fused_mega.mega_trace_dvr(rs, rd, net, *BOX, gauss, **kw, **g_kw)


@pytest.mark.parametrize("mode", ANYTF_MODES)
@pytest.mark.parametrize("which", sorted(ANYTF_NETS))
@pytest.mark.parametrize("lattice", [False, True])
def test_anytf_segment_matches_plain(mode, which, lattice):
    """Row 4 in each texture mode on a network other than SnakeAlt: both
    launches of segment_fwd_anytf, the call's stop, per-ray sampling or
    the lattice, against the plain version."""
    needs_card()
    net = random_net(**ANYTF_NETS[which]).cuda()
    rs, rd = block_rays(64, "cuda")
    h = 1 / 64
    tf, tf_kw = tf_mode_args(mode, h)
    kw = dict(stepsize=h, max_steps=112, seg=32, tile=128,
              latent_mode="boxfeat" if lattice else "table")
    before = fused_dvr.LIBRARY_LAUNCHES["segment_fwd_anytf"]
    with torch.no_grad():
        got, st = fused_dvr.fused_trace_dvr(rs, rd, net, *BOX, tf,
                                            return_stats=True, **kw, **tf_kw)
        want, st_plain = fused_dvr.fused_trace_dvr_plain(
            rs, rd, net, *BOX, tf, return_stats=True, **kw, **tf_kw)
    torch.cuda.synchronize()
    assert fused_dvr.LIBRARY_LAUNCHES["segment_fwd_anytf"] == before + 2
    assert float(want[:, 3].max()) > 0.5
    assert_within_noise(got, want, fused_dvr.fused_trace_dvr_plain,
                        (rs, rd, net, *BOX, tf), dict(kw, **tf_kw), mode)
    assert int(st.stop) == int(st_plain.stop)


@pytest.mark.parametrize("mode", ["preint1d", "preint2d"])
def test_tf_mode_mega_masked_matches_plain(mode):
    """A culled segment leaves the previous density alone: the masked
    render and the masked differentiable pair against the plain versions
    with the same mask."""
    needs_card()
    net, _, rays, spec = diff_case("random", True)
    mask = random_mask(rays, spec)
    rs, rd = block_rays(64, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    h = 1 / 128
    tf, tf_kw = tf_mode_args(mode, h)
    kw = dict(stepsize=h, tmax_clip=clip, segment_active=mask)
    with torch.no_grad():
        got = fused_mega.mega_trace_dvr(rs, rd, net, *BOX, tf, **kw, **tf_kw)
        want = fused_mega.mega_trace_dvr_plain(rs, rd, net, *BOX, tf, **kw,
                                               **tf_kw)
    assert_image_close(got, want, mode)
    args = (rs, rd, net, *BOX)
    kw = dict(kw, differentiable=True)
    img, got = tf_grads(fused_mega.mega_trace_dvr, args, kw, tf, tf_kw)
    img_plain, want = tf_grads(fused_mega.mega_trace_dvr_plain, args, kw,
                               tf, tf_kw)
    share, tols = flip_bounds(mode, fused_mega.mega_trace_dvr_plain, args,
                              kw, tf, tf_kw, img_plain, want)
    assert_image_close(img, img_plain, mode, share)
    for name in want:
        if mode == "preint2d" and name != "pre":
            continue
        assert rel_err(got[name], want[name]) <= tols[name], name


@pytest.mark.parametrize("mode", ["texture", "preint1d"])
def test_tf_mode_backward_deterministic(mode):
    """The texture and preint1d tables' gradients come from the blocks'
    partial rows: two backward launches give bitwise-equal rows."""
    needs_card()
    net = case_net("random")
    rs, rd = block_rays(64, "cuda")
    h = 1 / 128
    tf, tf_kw = tf_mode_args(mode, h)
    rows = []
    for _ in range(2):
        tf_leaf = tf.clone().requires_grad_(True)
        img = fused_mega.mega_trace_dvr(rs, rd, net, *BOX, tf_leaf,
                                        stepsize=h, differentiable=True,
                                        **tf_kw)
        (img ** 2).sum().backward()
        rows.append(tf_leaf.grad.clone())
    torch.cuda.synchronize()
    assert float(rows[0].abs().max()) > 0
    assert torch.equal(rows[0], rows[1])


def test_tf_mode_kernel_limits():
    """What the kernels refuse in the TF modes: a Gaussian TF on a network
    other than SnakeAlt in the segment kernel's render; the render and the
    training pair take the texture TF on every network, the training pair
    the Gaussians too, and any number of them."""
    tf, _, _ = fused_dvr.prepare_tf(torch.rand(256, 4), "texture")
    gauss = torch.rand(4, 6)
    relu = random_net(activation="ReLU")
    for diff in (False, True):
        fused_dvr._check_kernel_inputs(relu, tf, tf_mode="texture",
                                       differentiable=diff)
        fused_dvr._check_kernel_inputs(random_net(), tf, tf_mode="texture",
                                       differentiable=diff)
    with pytest.raises(NotImplementedError, match="gaussian"):
        fused_dvr._check_kernel_inputs(relu, gauss, tf_mode="gaussian")
    fused_dvr._check_kernel_inputs(relu, gauss, tf_mode="gaussian",
                                   differentiable=True)
    for n in (TF_STAGED_POINTS + 1, 4 * TF_STAGED_POINTS):
        many = torch.rand(n, 6)
        for diff in (False, True):
            fused_dvr._check_kernel_inputs(random_net(), many,
                                           tf_mode="gaussian",
                                           differentiable=diff)
        fused_dvr._check_kernel_inputs(relu, many, tf_mode="gaussian",
                                       differentiable=True)


# every TF mode on every network in training: rows 2-3
# (csrc/mega_fwd_anytf*.cu and, for the Gaussians, csrc/mega_fwd_anyg*.cu,
# MEGA_PART 3 and 4; csrc/mega_bwd.cuh) and rows 5-6
# (csrc/segment_fwd_anytf.cu and csrc/segment_fwd_anyg.cu, SEGMENT_TF_MODES
# 2 and 3; csrc/segment_bwd.cu), the cases chip_smoke.py phase Y holds at
# full size
TRAIN_NETS = {
    "relu_dir": dict(activation="ReLU", direction=True),
    "sine30": dict(activation="Sine", act_param=30.0),
    "relu_dir64": dict(activation="ReLU", direction=True, width=64),
}


def train_bounds(mode, which, plain_march, args, kw, tf, tf_kw, img, want):
    """(image mode, share, tolerances) of a training case: flip_bounds'.
    Sine:30's gradients are ill-conditioned in float32 in every mode (one
    ulp of weight noise moves them by up to ~5%), so its image and every
    leaf take the noise bounds that flip_bounds gives the preintegrating
    modes."""
    as_mode = "preint1d" if which == "sine30" else mode
    share, tols = flip_bounds(as_mode, plain_march, args, kw, tf, tf_kw, img,
                              want)
    return as_mode, share, tols


def assert_grads_close(mode, got, want, tols, bf16=False):
    """Every leaf of ``got`` within its tolerance of ``want``'s (a bf16
    table's grid per element, ``bf16_grid_close``); preint2d's network
    leaves zero or absent on both sides."""
    if mode != "preint2d":
        assert sorted(got) == sorted(want)
    for name in want:
        if mode == "preint2d" and name != "pre":
            assert name not in got or float(got[name].abs().max()) == 0.0
            continue
        if name == "latent.static_grid" and bf16:
            bf16_grid_close(got[name], want[name])
            continue
        assert rel_err(got[name], want[name]) <= tols[name], name


@pytest.mark.parametrize(
    "which,mode,table",
    [(w, m, "f32") for w in sorted(TRAIN_NETS) for m in TF_MODES]
    + [("relu_dir", m, "bf16") for m in TF_MODES])
def test_anytf_mega_training_matches_plain(which, mode, table):
    """Rows 2-3 in each TF mode on a network other than SnakeAlt without
    direction input: one launch of the width's mega_fwd_anytf library
    (mega_fwd_anyg for the Gaussians) and one of mega_bwd, the image and
    every gradient leaf against the plain pair, on a float32 table (and
    the first network on a bf16 one)."""
    needs_card()
    net = random_net(**TRAIN_NETS[which]).cuda()
    rs, rd = block_rays(64, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    h = 1 / 128
    tf, tf_kw = tf_mode_args(mode, h)
    kw = dict(stepsize=h, tmax_clip=clip, differentiable=True,
              table_dtype=torch.bfloat16 if table == "bf16"
              else torch.float32)
    args = (rs, rd, net, *BOX)
    lib = fused_mega.library_name(
        "mega_fwd_anyg" if mode == "gaussian" else "mega_fwd_anytf",
        fused_mega.kernel_width(net))
    before = (fused_mega.LIBRARY_LAUNCHES[lib],
              fused_mega.launches("mega_bwd"))
    img, got = tf_grads(fused_mega.mega_trace_dvr, args, kw, tf, tf_kw)
    assert (fused_mega.LIBRARY_LAUNCHES[lib],
            fused_mega.launches("mega_bwd")) == (before[0] + 1,
                                                 before[1] + 1)
    img_plain, want = tf_grads(fused_mega.mega_trace_dvr_plain, args, kw,
                               tf, tf_kw)
    assert float(img_plain[:, 3].max()) > 0.5
    as_mode, share, tols = train_bounds(
        mode, which, fused_mega.mega_trace_dvr_plain, args, kw, tf, tf_kw,
        img_plain, want)
    assert_image_close(img, img_plain, as_mode, share)
    assert_grads_close(mode, got, want, tols, bf16=table == "bf16")


@pytest.mark.parametrize("mode", TF_MODES)
@pytest.mark.parametrize("which", sorted(TRAIN_NETS))
def test_anytf_segment_training_matches_plain(which, mode):
    """Rows 5-6 in each TF mode on a network other than SnakeAlt: one
    launch of segment_fwd_anytf (segment_fwd_anyg for the Gaussians)
    storing carries and one of segment_bwd, the image and every gradient
    leaf against the plain pair."""
    needs_card()
    net = random_net(**TRAIN_NETS[which]).cuda()
    rs, rd = block_rays(64, "cuda")
    h = 1 / 64
    tf, tf_kw = tf_mode_args(mode, h)
    kw = dict(stepsize=h, max_steps=112, seg=32, tile=128,
              differentiable=True)
    args = (rs, rd, net, *BOX)
    lib = "segment_fwd_anyg" if mode == "gaussian" else "segment_fwd_anytf"
    before = (fused_dvr.LIBRARY_LAUNCHES[lib],
              fused_dvr_bwd.launches("segment_bwd"))
    img, got = tf_grads(fused_dvr.fused_trace_dvr, args, kw, tf, tf_kw)
    assert (fused_dvr.LIBRARY_LAUNCHES[lib],
            fused_dvr_bwd.launches("segment_bwd")) == (before[0] + 1,
                                                    before[1] + 1)
    img_plain, want = tf_grads(fused_dvr.fused_trace_dvr_plain, args, kw,
                               tf, tf_kw)
    assert float(img_plain[:, 3].max()) > 0.5
    as_mode, share, tols = train_bounds(
        mode, which, fused_dvr.fused_trace_dvr_plain, args, kw, tf, tf_kw,
        img_plain, want)
    assert_image_close(img, img_plain, as_mode, share)
    assert_grads_close(mode, got, want, tols)


def test_anytf_gaussian_mega_refuses_a_mask():
    """The generic Gaussian instance is unmasked (the training forward
    takes no occupancy mask on these networks): a mask raises."""
    rays = torch.zeros(512, 8)
    net = random_net(activation="ReLU", direction=True)
    fused_mega._check_kernel_inputs(net, rays, 256, tf_floats=24,
                                    tf_mode="gaussian", differentiable=True)
    with pytest.raises(NotImplementedError, match="occupancy mask"):
        fused_mega._check_kernel_inputs(net, rays, 256, tf_floats=24,
                                        tf_mode="gaussian",
                                        differentiable=True, masked=True)


# ---------------------------------------------------------------------------
# normals and shading: the normals instances of rows 1 and 4
# (csrc/mega_fwd.cuh, csrc/segment_fwd.cuh with position_grad.cuh) and row
# 7's gradient instance inside the Monte-Carlo walk

NRM_PHONG = dict(enable_phong=True, ambient=0.2, specular=0.3,
                 magnitude_center=0.02, magnitude_radius=0.02,
                 light=(0.3, -0.5, -1.0))
NRM_BRDFS = {
    "none": None,
    "phong": NRM_PHONG,
    "point_magnitude": dict(NRM_PHONG, light=(0.8, 1.2, -1.5),
                            light_type="point", specular_exponent=5,
                            enable_magnitude_scaling=True,
                            magnitude_scaling=200.0),
}
# share of rays whose colour, normal or depth may leave the contract: a
# sample at a clip or ReLU kink of the network, or at |g|^2 = 1e-12, switches
# its gradient (and so its normal and shading) on float32 noise between the
# kernel's scalar sweep and autograd through the plain network
NRM_FLIP_SHARE = 1e-2
NRM_CASES = {
    **{f"w{w}_{tab}": dict(net=dict(width=w), table=tab)
       for w in (32, 48, 64, 128) for tab in ("f32", "bf16")},
    "flagship": dict(net="flagship", table="bf16"),
    "relu48_direction": dict(net=dict(width=48, activation="ReLU",
                                      direction=True, output_mode="density"),
                             table="f32"),
    "sine_nogrid": dict(net=dict(activation="Sine", channels=0),
                        table="f32"),
}


def nrm_case(case, brdf):
    from fvsrn_tpu_torch.brdf import BRDFLambert
    spec = NRM_CASES[case]
    _, tf, npz = dense_scene()
    net = (load_weights(npz) if spec["net"] == "flagship"
           else random_net(**spec["net"])).cuda()
    b = NRM_BRDFS[brdf]
    return (net, tf.tensor.cuda(), BRDFLambert.make(**b) if b else None,
            torch.bfloat16 if spec["table"] == "bf16" else torch.float32)


def normals_match(got, want, shaded):
    """Colour (1e-4, shaded 2e-4), normal (5e-4) and depth (1e-4) of the
    kernel against the plain version on all but NRM_FLIP_SHARE of the
    rays; the scene has normals."""
    err = torch.stack([
        (got.color - want.color).abs().amax(1) / (2e-4 if shaded else 1e-4),
        (got.normal - want.normal).abs().amax(1) / 5e-4,
        (got.depth - want.depth).abs().amax(1) / 1e-4], 1).amax(1)
    off = float((err > 1.0).float().mean())
    print(f"{off:.5f} of the rays off, worst {float(err.max()):.3g} of the "
          "tolerance")
    assert off <= NRM_FLIP_SHARE
    assert float(want.normal.abs().max()) > 0.1
    assert float(want.color[:, 3].max()) > 0.05


@pytest.mark.parametrize("brdf", ["phong", "point_magnitude"])
@pytest.mark.parametrize("case", sorted(NRM_CASES))
def test_mega_normals_kernel_matches_plain(case, brdf):
    """Row 1's normals instance of each width and table against its plain
    version on 64x64 block-ordered rays, the tile vote on; one launch of
    the normals instance a call, none by the plain version."""
    needs_card()
    net, tf, b, tdt = nrm_case(case, brdf)
    rs, rd = block_rays(64, "cuda")
    args = (rs, rd, net, *BOX, tf)
    kw = dict(stepsize=1 / 128, need_normals=True, brdf=b, table_dtype=tdt)
    before = (fused_mega.launches("mega_fwd_nrm"),
              fused_mega.launches("mega_fwd"))
    got = fused_mega.mega_trace_dvr(*args, **kw)
    torch.cuda.synchronize()
    assert (fused_mega.launches("mega_fwd_nrm"),
            fused_mega.launches("mega_fwd")) == (before[0] + 1, before[1])
    want = fused_mega.mega_trace_dvr_plain(*args, **kw)
    assert fused_mega.launches("mega_fwd_nrm") == before[0] + 1
    normals_match(got, want, True)


@pytest.mark.parametrize("lattice,brdf", [(False, "phong"),
                                          (True, "point_magnitude"),
                                          (False, "none")])
@pytest.mark.parametrize("case", sorted(NRM_CASES))
def test_segment_normals_kernel_matches_plain(case, lattice, brdf):
    """Row 4's normals instance of each width and table against its plain
    version on a 60x44 view padded to whole tiles, per-ray or lattice
    sampling: colour, normal, depth, samples and the call's stop; two
    launches a call."""
    needs_card()
    net, tf, b, tdt = nrm_case(case, brdf)
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.8,
                                                distance=1.6),
                           60, 44, device="cuda")
    rs, rd, _ = pad_rays(rs.reshape(-1, 3), rd.reshape(-1, 3), 128)
    kw = dict(stepsize=1 / 128, max_steps=222, seg=32, tile=128,
              table_dtype=tdt, need_normals=True, brdf=b, return_stats=True,
              latent_mode="boxfeat" if lattice else "table")
    args = (rs, rd, net, *BOX, tf)
    before = (fused_dvr.SEGMENT_NRM_LAUNCHES, fused_dvr.SEGMENT_LAUNCHES)
    got, stats = fused_dvr.fused_trace_dvr(*args, **kw)
    torch.cuda.synchronize()
    assert (fused_dvr.SEGMENT_NRM_LAUNCHES, fused_dvr.SEGMENT_LAUNCHES) == (
        before[0] + 2, before[1])
    want, want_stats = fused_dvr.fused_trace_dvr_plain(*args, **kw)
    normals_match(got, want, b is not None)
    assert int(stats.samples) == int(want_stats.samples)
    assert int(stats.stop) == int(want_stats.stop)


def test_normals_kernels_refuse_other_tf_modes():
    """The normals instances take the piecewise TF: another TF mode with
    normals raises on the card (it does not run the plain version); so
    does row 1's normals instance on a tile other than 256 rays."""
    tf, _, _ = fused_dvr.prepare_tf(torch.rand(16, 4), "texture")
    with pytest.raises(NotImplementedError, match="normals"):
        fused_dvr._check_kernel_inputs(random_net(), tf, tf_mode="texture",
                                       need_normals=True)
    rays = torch.zeros(256, 8)
    with pytest.raises(NotImplementedError, match="normals"):
        fused_mega._check_kernel_inputs(random_net(), rays, 256,
                                        tf_mode="texture", need_normals=True)
    with pytest.raises(NotImplementedError, match="normals on tiles"):
        fused_mega._check_kernel_inputs(random_net(), rays, 128,
                                        need_normals=True)
    fused_mega._check_kernel_inputs(random_net(), rays, 128)


def test_mc_walk_gradient_instance_matches_plain():
    """The MC walk with a gradient-scaled Gaussian TF through the fused
    sampler: every camera-walk round one launch of row 7's gradient
    instance (values and normals), every shadow-walk round one of the
    value instance; the frame against the plain trace_mc on the same key
    (>= 98% of the rays within 1e-3)."""
    needs_card()
    from fvsrn_tpu_torch.models.network_volume import \
        VolumeInterpolationNetwork
    from fvsrn_tpu_torch.phase import PhaseFunctionHenyeyGreenstein
    from fvsrn_tpu_torch.raytracer import montecarlo as tmc
    from fvsrn_tpu_torch.transfer import TransferFunctionGaussian
    from fvsrn_tpu_torch.utils import prng
    _, _, npz = dense_scene()
    vol = VolumeInterpolationNetwork(load_weights(npz).cuda())
    tf = TransferFunctionGaussian(torch.tensor(
        [[0.9, 0.3, 0.2, 8.0, 0.3, 0.5], [0.2, 0.8, 0.9, 6.0, 0.7, 0.5]],
        device="cuda"), scale_with_gradient=True)
    cfg = tmc.RayEvaluationMonteCarlo.make(max_absorption=14.0,
                                           num_bounces=1, max_iterations=128)
    rs, rd = block_rays(64, "cuda")
    hg = PhaseFunctionHenyeyGreenstein.make(g=0.3)
    plain = tmc.trace_mc(prng.prng_key(7), rs, rd, vol, tf, hg, cfg)
    before = (fused_eval.SAMPLE_EVAL_LAUNCHES,
              fused_eval.SAMPLE_GRAD_LAUNCHES, tmc.TRACKING_ROUNDS,
              tmc.NORMAL_ROUNDS)
    fused = tmc.trace_mc(prng.prng_key(7), rs, rd, vol, tf, hg, cfg,
                         use_fused=True)
    torch.cuda.synchronize()
    launches, grads, rounds, normal_rounds = (
        a - b for a, b in zip((fused_eval.SAMPLE_EVAL_LAUNCHES,
                               fused_eval.SAMPLE_GRAD_LAUNCHES,
                               tmc.TRACKING_ROUNDS, tmc.NORMAL_ROUNDS),
                              before))
    assert grads == normal_rounds > 0
    assert launches == rounds
    got = torch.cat([fused.color, fused.normal, fused.depth], 1)
    want = torch.cat([plain.color, plain.normal, plain.depth], 1)
    close = ((got - want).abs() < 1e-3).all(dim=1)
    assert float(close.float().mean()) >= 0.98
    assert 0.05 < float(plain.color[:, 3].mean()) < 1.0


# time- and ensemble-conditioned networks (rows 1-7 through
# ops.fused_dvr.resolve_network: keyframed grids lerped into one static
# grid, latent vectors folded into layer 0's bias)

def latent_net(kind, seed=5):
    """A random network (``random_net``) whose latent columns belong to
    keyframed grids ("keyframed": a 3-keyframe time grid and a 2-keyframe
    ensemble grid, 8 channels each) or to latent vectors and a grid
    ("vectors": an ensemble vector of 2 channels, a time vector of 4, an
    8-channel grid)."""
    from fvsrn_tpu_torch.models.latent import LatentSpace
    rng = np.random.default_rng(seed)

    def g(*shape):
        return torch.tensor(rng.standard_normal(shape) * 0.3,
                            dtype=torch.float32)

    net = random_net(seed=seed, channels=16 if kind == "keyframed" else 14)
    if kind == "keyframed":
        net.latent = LatentSpace(time_grid=g(3, 8, 8, 8, 8),
                                 ensemble_grid=g(2, 8, 8, 8, 8),
                                 time_dependent=True)
    else:
        net.latent = LatentSpace(static_grid=g(8, 8, 8, 8),
                                 ensemble_vector=g(1, 2, 3),
                                 time_vector=g(1, 4, 4))
    return net.cuda()


LATENT_AT = dict(time=1.4, ensemble=0.6)


@pytest.mark.parametrize("kind", ["keyframed", "vectors"])
def test_latent_mega_matches_plain(kind):
    """Rows 1-3 on a conditioned network: the render (bf16 table), and the
    differentiable pair's image and every leaf, keyframes and vectors
    included; the keyframe outside the bracket gets exactly zero."""
    needs_card()
    net = latent_net(kind)
    tf = dense_scene()[1].tensor.cuda()
    rs, rd = block_rays(64, "cuda")
    kw = dict(stepsize=1 / 128, **LATENT_AT)
    before = fused_mega.launches("mega_fwd")
    got = fused_mega.mega_trace_dvr(rs, rd, net, *BOX, tf, **kw)
    torch.cuda.synchronize()
    assert fused_mega.launches("mega_fwd") == before + 1
    want = fused_mega.mega_trace_dvr_plain(rs, rd, net, *BOX, tf, **kw)
    assert float(want[:, 3].max()) > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    res = {}
    for fn in (fused_mega.mega_trace_dvr, fused_mega.mega_trace_dvr_plain):
        net.zero_grad(set_to_none=True)
        img = fn(rs, rd, net, *BOX, tf, differentiable=True, **kw)
        (img ** 2).mean().backward()
        res[fn] = (img.detach(), {n: p.grad.clone()
                                  for n, p in net.named_parameters()})
    (img_k, g_k), (img_p, g_p) = res.values()
    torch.testing.assert_close(img_k, img_p, rtol=0, atol=ATOL)
    for name in g_p:
        assert rel_err(g_k[name], g_p[name]) <= 1e-3, name
    if kind == "keyframed":
        assert float(g_k["latent.time_grid"][0].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["keyframed", "vectors"])
def test_latent_segment_matches_plain(kind):
    """Rows 4-6 on a conditioned network: the render, and the
    differentiable pair's image and every leaf."""
    needs_card()
    net = latent_net(kind)
    tf = dense_scene()[1].tensor.cuda()
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.8,
                                                distance=1.6),
                           60, 44, device="cuda")
    rs, rd, _ = pad_rays(rs.reshape(-1, 3), rd.reshape(-1, 3), 128)
    kw = dict(stepsize=1 / 128, max_steps=222, seg=32, tile=128,
              **LATENT_AT)
    before = fused_dvr.SEGMENT_LAUNCHES
    got = fused_dvr.fused_trace_dvr(rs, rd, net, *BOX, tf, **kw)
    torch.cuda.synchronize()
    assert fused_dvr.SEGMENT_LAUNCHES == before + 2
    want = fused_dvr.fused_trace_dvr_plain(rs, rd, net, *BOX, tf, **kw)
    assert float(want[:, 3].max()) > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    res = {}
    for fn in (fused_dvr.fused_trace_dvr, fused_dvr.fused_trace_dvr_plain):
        net.zero_grad(set_to_none=True)
        img = fn(rs, rd, net, *BOX, tf, differentiable=True, **kw)
        (img ** 2).mean().backward()
        res[fn] = (img.detach(), {n: p.grad.clone()
                                  for n, p in net.named_parameters()})
    (img_k, g_k), (img_p, g_p) = res.values()
    torch.testing.assert_close(img_k, img_p, rtol=0, atol=ATOL)
    for name in g_p:
        assert rel_err(g_k[name], g_p[name]) <= 1e-3, name
    if kind == "keyframed":
        assert float(g_k["latent.time_grid"][0].abs().max()) == 0.0


@pytest.mark.parametrize("want_grad", [False, True])
@pytest.mark.parametrize("kind", ["keyframed", "vectors"])
def test_latent_sample_eval_matches_plain(kind, want_grad):
    """Row 7 on a conditioned network at (1.4, 0.6): values and the
    position gradient against the plain version at the same
    conditioning."""
    needs_card()
    net = latent_net(kind)
    gen = torch.Generator("cuda").manual_seed(0)
    pos = torch.rand(5000, 3, device="cuda", generator=gen) * 1.4 - 0.7
    ev = fused_eval.make_fused_eval(net, *BOX, want_grad=want_grad,
                                    **LATENT_AT)
    before = fused_eval.SAMPLE_EVAL_LAUNCHES
    got = ev(pos)
    torch.cuda.synchronize()
    assert fused_eval.SAMPLE_EVAL_LAUNCHES == before + 1
    value, grad = fused_eval.fused_eval_plain(net, pos + 0.5,
                                              want_grad=want_grad,
                                              **LATENT_AT)
    torch.testing.assert_close(got[0], value, rtol=0, atol=ATOL)
    if want_grad:
        inner = (pos.abs() < 0.45).all(dim=1) & (value > 0) & (value < 1)
        assert rel_err(got[2][inner], grad[inner]) <= 1e-3


# ---------------------------------------------------------------------------
# the wide networks (hidden widths 65-128, csrc/*128.cu: the wide plans of
# warp_mlp.cuh and sample_mlp.cuh, hidden matrices read from device
# memory) on rows 1-7, and layers of mixed widths (each padded to the
# widest's instance) on the forward rows 1, 4 and 7

WIDE_NETS = {
    "w128": dict(width=128, output_mode="density"),
    "w96_relu_dir": dict(width=96, activation="ReLU", direction=True,
                         output_mode="density"),
    "mixed64_32": dict(widths=[64, 32], output_mode="density"),
    "mixed48_96": dict(widths=[48, 96], activation="ReLU", direction=True,
                       output_mode="density"),
}
WIDE_TRAIN = ("w128", "w96_relu_dir")
WIDE_MODES = ("piecewise", "texture", "gaussian")


def wide_tf(mode, h):
    """(tf tensor, tf keywords) of the ramp TF in ``mode`` on the card."""
    if mode == "piecewise":
        return dense_scene()[1].tensor.cuda(), {}
    return tf_mode_args(mode, h)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("which", sorted(WIDE_NETS))
def test_wide_mega_render_matches_plain(which, masked):
    """Row 1 on a wide or mixed network: the render (bf16 table, the tile
    vote on, clipped rays; with an occupancy mask too) against the plain
    version, one launch of the widest layer's instance."""
    needs_card()
    net = random_net(**WIDE_NETS[which]).cuda()
    _, tf, rays, spec = diff_case(None, True, net)
    rs, rd = block_rays(64, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    mask = random_mask(rays, spec) if masked else None
    kw = dict(stepsize=1 / 128, tmax_clip=clip, return_samples=True,
              segment_active=mask)
    args = (rs, rd, net, *BOX, tf)
    hp = fused_mega.kernel_width(net)
    lib = fused_mega.library_name(
        fused_mega._fwd_kind(spec, fused_mega._net_args(spec)), hp)
    before = fused_mega.LIBRARY_LAUNCHES[lib]
    got, samples = fused_mega.mega_trace_dvr(*args, **kw)
    torch.cuda.synchronize()
    assert fused_mega.LIBRARY_LAUNCHES[lib] == before + 1
    want, samples_plain = fused_mega.mega_trace_dvr_plain(*args, **kw)
    assert float(want[:, 3].max()) > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert torch.equal(samples.long(), samples_plain)


@pytest.mark.parametrize("mode", WIDE_MODES)
@pytest.mark.parametrize("which", WIDE_TRAIN)
def test_wide_mega_training_matches_plain(which, mode):
    """Rows 2-3 on a wide network: one launch of the 128 instance's
    forward and of mega_bwd128, the image and every gradient leaf against
    the plain pair."""
    needs_card()
    net = random_net(**WIDE_NETS[which]).cuda()
    rs, rd = block_rays(64, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    h = 1 / 128
    tf, tf_kw = wide_tf(mode, h)
    kw = dict(stepsize=h, tmax_clip=clip, differentiable=True,
              table_dtype=torch.float32)
    args = (rs, rd, net, *BOX)
    before = (fused_mega.LAUNCHES["mega_fwd_diff:t256:f32"],
              fused_mega.LAUNCHES["mega_bwd:t256:f32"])
    img, got = tf_grads(fused_mega.mega_trace_dvr, args, kw, tf, tf_kw)
    assert (fused_mega.LAUNCHES["mega_fwd_diff:t256:f32"],
            fused_mega.LAUNCHES["mega_bwd:t256:f32"]) == (before[0] + 1,
                                                         before[1] + 1)
    img_plain, want = tf_grads(fused_mega.mega_trace_dvr_plain, args, kw,
                               tf, tf_kw)
    assert float(img_plain[:, 3].max()) > 0.5
    share, tols = flip_bounds(mode, fused_mega.mega_trace_dvr_plain, args,
                              kw, tf, tf_kw, img_plain, want)
    assert_image_close(img, img_plain, mode, share)
    assert_grads_close(mode, got, want, tols)


@pytest.mark.parametrize("which", sorted(WIDE_NETS))
def test_wide_segment_matches_plain(which):
    """Row 4 on a wide or mixed network: the per-segment engine's kernel
    (two launches of the widest layer's library) against its plain
    version: image, samples and the call's stop."""
    needs_card()
    net = random_net(**WIDE_NETS[which]).cuda()
    tf = dense_scene()[1].tensor.cuda()
    rs, rd = generate_rays(CameraOnASphere.make(pitch=0.3, yaw=0.8,
                                                distance=1.6),
                           60, 44, device="cuda")
    kw = dict(stepsize=1 / 128, max_steps=222, seg=32, tile=128,
              return_stats=True)
    rs, rd, _ = pad_rays(rs.reshape(-1, 3), rd.reshape(-1, 3), 128)
    args = (rs, rd, net, *BOX, tf)
    lib = fused_dvr.width_library("segment_fwd", fused_mega.kernel_width(net))
    before = fused_dvr.LIBRARY_LAUNCHES[lib]
    got, stats = fused_dvr.fused_trace_dvr(*args, **kw)
    torch.cuda.synchronize()
    assert fused_dvr.LIBRARY_LAUNCHES[lib] == before + 2
    want, want_stats = fused_dvr.fused_trace_dvr_plain(*args, **kw)
    assert float(want[:, 3].max()) > 0.05
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert int(stats.samples) == int(want_stats.samples)
    assert int(stats.stop) == int(want_stats.stop)


@pytest.mark.parametrize("mode", WIDE_MODES)
@pytest.mark.parametrize("which", WIDE_TRAIN)
def test_wide_segment_training_matches_plain(which, mode):
    """Rows 5-6 on a wide network: one launch of the 128 forward storing
    carries and one of segment_bwd128, the image and every gradient leaf
    against the plain pair."""
    needs_card()
    net = random_net(**WIDE_NETS[which]).cuda()
    rs, rd = block_rays(64, "cuda")
    h = 1 / 64
    tf, tf_kw = wide_tf(mode, h)
    kw = dict(stepsize=h, max_steps=112, seg=32, tile=128,
              differentiable=True)
    args = (rs, rd, net, *BOX)
    before = (fused_dvr_bwd.launches("segment_fwd_diff"),
              fused_dvr_bwd.launches("segment_bwd"))
    img, got = tf_grads(fused_dvr.fused_trace_dvr, args, kw, tf, tf_kw)
    assert (fused_dvr_bwd.launches("segment_fwd_diff"),
            fused_dvr_bwd.launches("segment_bwd")) == (before[0] + 1,
                                                    before[1] + 1)
    img_plain, want = tf_grads(fused_dvr.fused_trace_dvr_plain, args, kw,
                               tf, tf_kw)
    assert float(img_plain[:, 3].max()) > 0.5
    share, tols = flip_bounds(mode, fused_dvr.fused_trace_dvr_plain, args,
                              kw, tf, tf_kw, img_plain, want)
    assert_image_close(img, img_plain, mode, share)
    assert_grads_close(mode, got, want, tols)


@pytest.mark.parametrize("n", [33, 5000, 2 ** 18 + 7])
@pytest.mark.parametrize("which", sorted(WIDE_NETS))
def test_wide_sample_eval_matches_plain(which, n):
    """Row 7's value instance on a wide or mixed network against its
    plain version (sample_eval128 above 64 wide)."""
    needs_card()
    net = random_net(**WIDE_NETS[which]).cuda()
    gen = torch.Generator("cuda").manual_seed(0)
    pos = torch.rand(n, 3, device="cuda", generator=gen) * 1.4 - 0.7
    d = torch.randn(n, 3, device="cuda", generator=gen)
    sample_eval_matches(net, pos, d / d.norm(dim=1, keepdim=True))


def test_wide_refusals():
    """What the wide instances do not take: 128-ray tiles, layers of
    several widths in training, widths above 128. They take normals
    (rows 1 and 4) and row 7's gradient instance; normals with a TF mode
    other than piecewise stay refused at every width."""
    rays = torch.zeros(512, 8)
    tf = dense_scene()[1].tensor
    wide = random_net(width=96)
    fused_mega._check_kernel_inputs(wide, rays, 256, need_normals=True)
    fused_dvr._check_kernel_inputs(wide, tf, need_normals=True)
    assert fused_mega.check_kernel_width(wide, "row 7") == 128
    with pytest.raises(NotImplementedError, match="normals"):
        fused_mega._check_kernel_inputs(wide, rays, 256, need_normals=True,
                                        tf_floats=1024, tf_mode="texture")
    with pytest.raises(NotImplementedError, match="tiles of 128"):
        fused_mega._check_kernel_inputs(wide, rays, 128)
    mixed = random_net(widths=[64, 32])
    with pytest.raises(NotImplementedError, match="several widths"):
        fused_dvr._check_kernel_inputs(mixed, tf, differentiable=True)
    with pytest.raises(NotImplementedError, match="up to 128"):
        fused_mega.kernel_width(random_net(width=144))


@pytest.mark.parametrize("n", [33, 5000])
@pytest.mark.parametrize("which", sorted(WIDE_NETS))
def test_wide_sample_eval_gradient_matches_plain(which, n):
    """Row 7's gradient instance on a wide or mixed network (sample_eval128
    above 64 wide, its weights read from device memory): values and the
    position gradient against the plain version."""
    needs_card()
    net = random_net(**WIDE_NETS[which]).cuda()
    gen = torch.Generator("cuda").manual_seed(1)
    pos = torch.rand(n, 3, device="cuda", generator=gen) * 1.4 - 0.7
    d = torch.randn(n, 3, device="cuda", generator=gen)
    sample_eval_matches(net, pos, d / d.norm(dim=1, keepdim=True),
                        want_grad=True)


# ---------------------------------------------------------------------------
# TFs of any size on rows 1-6: up to TF_STAGED_POINTS knots or Gaussians
# staged in shared memory, more read from the packed weights in device
# memory; the flagship's ramp as that many points (scenes.dense_tf_points)
# at every width, on every instance family that takes the mode

KNOT_COUNTS = (17, TF_STAGED_POINTS, TF_STAGED_POINTS + 1,
               2 * TF_STAGED_POINTS)
KNOT_WIDTHS = (32, 48, 64, 128)


def knots_case(width, n, gaussian=False, **net_kw):
    """(net, tf tensor, tf keywords) on the card: a density-head network
    of ``width`` and the ramp as ``n`` knots or Gaussians."""
    net = random_net(width=width, output_mode="density", **net_kw).cuda()
    tf = dense_tf_points(n, gaussian).cuda()
    return net, tf, dict(tf_mode="gaussian") if gaussian else {}


def clipped_rays(width=32):
    rs, rd = block_rays(width, "cuda")
    clip = torch.empty(rs.shape[0], device="cuda").uniform_(
        1.0, 2.2, generator=torch.Generator("cuda").manual_seed(0))
    return rs, rd, clip


@pytest.mark.parametrize("width", KNOT_WIDTHS)
@pytest.mark.parametrize("n", KNOT_COUNTS)
def test_knots_mega_render_matches_plain(n, width):
    """Row 1 with n knots: SnakeAlt (mega_fwd), with an occupancy mask,
    on 128-ray tiles (to 64 wide), a ReLU network with direction input
    (mega_fwd_any) and the Gaussians on SnakeAlt (mega_fwd_tf): image and
    samples against the plain version, one launch a call."""
    needs_card()
    rs, rd, clip = clipped_rays()
    cases = [(dict(), {}, 256, False), (dict(), {}, 256, True),
             (dict(activation="ReLU", direction=True), {}, 256, False),
             (dict(), dict(gaussian=True), 256, False)]
    if width <= fused_mega.SMEM_MAX_WIDTH:
        cases.append((dict(), {}, 128, False))
    for net_kw, tf_kw, tile, masked in cases:
        net, tf, mode = knots_case(width, n, **tf_kw, **net_kw)
        args = (rs, rd, net, *BOX, tf)
        kw = dict(stepsize=1 / 128, tmax_clip=clip, tile=tile,
                  return_samples=True, **mode)
        if masked:
            spec = fused_mega._spec(net, *BOX, stepsize=1 / 128, seg=32,
                                    tile=256, density_min=0.0,
                                    density_max=1.0, enable_early_out=True)
            kw["segment_active"] = random_mask(fused_mega.ray_packet(
                rs, rd, *BOX, 1 / 128, clip), spec)
        before = fused_mega.launches("mega_fwd")
        got, samples = fused_mega.mega_trace_dvr(*args, **kw)
        torch.cuda.synchronize()
        assert fused_mega.launches("mega_fwd") == before + 1
        want, samples_plain = fused_mega.mega_trace_dvr_plain(*args, **kw)
        assert float(want[:, 3].max()) > 0.5
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        assert torch.equal(samples.long(), samples_plain)


@pytest.mark.parametrize("width", KNOT_WIDTHS)
@pytest.mark.parametrize("n", KNOT_COUNTS)
def test_knots_segment_render_matches_plain(n, width):
    """Row 4 with n knots (segment_fwd) and n Gaussians on SnakeAlt
    (segment_fwd_tf): image, samples and the call's stop against the
    plain version, two launches a call."""
    needs_card()
    rs, rd = view_rays()
    for gaussian in (False, True):
        net, tf, mode = knots_case(width, n, gaussian)
        args = (rs, rd, net, *BOX, tf)
        kw = dict(SEG_FWD_KW, return_stats=True, **mode)
        before = fused_dvr.SEGMENT_LAUNCHES
        got, stats = fused_dvr.fused_trace_dvr(*args, **kw)
        torch.cuda.synchronize()
        assert fused_dvr.SEGMENT_LAUNCHES == before + 2
        want, want_stats = fused_dvr.fused_trace_dvr_plain(*args, **kw)
        assert float(want[:, 3].max()) > 0.5
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        assert int(stats.samples) == int(want_stats.samples)
        assert int(stats.stop) == int(want_stats.stop)


@pytest.mark.parametrize("engine", ["mega", "segment"])
@pytest.mark.parametrize("width", KNOT_WIDTHS)
@pytest.mark.parametrize("n", KNOT_COUNTS)
def test_knots_normals_match_plain(n, width, engine):
    """Rows 1 and 4's normals instances with n knots (Phong, a point
    light with magnitude scaling): colour, normal and depth against the
    plain version on all but NRM_FLIP_SHARE of the rays."""
    needs_card()
    from fvsrn_tpu_torch.brdf import BRDFLambert
    net, tf, _ = knots_case(width, n)
    b = BRDFLambert.make(**NRM_BRDFS["point_magnitude"])
    if engine == "mega":
        rs, rd = block_rays(32, "cuda")
        kw = dict(stepsize=1 / 128)
        march, plain = fused_mega.mega_trace_dvr, \
            fused_mega.mega_trace_dvr_plain
    else:
        rs, rd = view_rays()
        kw = dict(SEG_FWD_KW)
        march, plain = fused_dvr.fused_trace_dvr, \
            fused_dvr.fused_trace_dvr_plain
    kw.update(need_normals=True, brdf=b, table_dtype=torch.float32)
    args = (rs, rd, net, *BOX, tf)
    before = (fused_mega.launches("mega_fwd_nrm"),
              fused_dvr.SEGMENT_NRM_LAUNCHES)
    got = march(*args, **kw)
    torch.cuda.synchronize()
    after = (fused_mega.launches("mega_fwd_nrm"),
             fused_dvr.SEGMENT_NRM_LAUNCHES)
    assert after == ((before[0] + 1, before[1]) if engine == "mega"
                     else (before[0], before[1] + 2))
    normals_match(got, plain(*args, **kw), True)


@pytest.mark.parametrize("mode", ["piecewise", "gaussian"])
@pytest.mark.parametrize("width", KNOT_WIDTHS)
@pytest.mark.parametrize("n", KNOT_COUNTS)
def test_knots_mega_training_matches_plain(n, width, mode):
    """Rows 2-3 with n knots or Gaussians: SnakeAlt on a float32 and a
    bf16 table (mega_fwd / mega_fwd_tf, mega_bwd), the ray-gradient
    instance, and a ReLU network with direction input (mega_fwd_any /
    mega_fwd_anyg): the image and every gradient leaf (the TF's too)
    against the plain pair, one launch of each kernel."""
    needs_card()
    rs, rd, clip = clipped_rays()
    h = 1 / 128
    for net_kw, table, rays in (
            (dict(), torch.float32, False), (dict(), torch.bfloat16, False),
            (dict(), torch.float32, True),
            (dict(activation="ReLU", direction=True), torch.float32, False)):
        net, tf, tf_kw = knots_case(width, n, mode == "gaussian", **net_kw)
        kw = dict(stepsize=h, tmax_clip=clip, differentiable=True,
                  table_dtype=table)
        if rays:
            kw["ray_grads"] = True
        args = (rs.clone().requires_grad_(rays),
                rd.clone().requires_grad_(rays), net, *BOX)
        before = (fused_mega.launches("mega_fwd_diff"),
                  fused_mega.launches("mega_bwd"))
        img, got = tf_grads(fused_mega.mega_trace_dvr, args, kw, tf, tf_kw)
        assert (fused_mega.launches("mega_fwd_diff"),
                fused_mega.launches("mega_bwd")) == (before[0] + 1,
                                                     before[1] + 1)
        img_plain, want = tf_grads(fused_mega.mega_trace_dvr_plain, args,
                                   kw, tf, tf_kw)
        assert float(img_plain[:, 3].max()) > 0.5
        torch.testing.assert_close(img, img_plain, rtol=0, atol=ATOL)
        assert_grads_close(mode, got, want, {k: 1e-3 for k in want},
                           bf16=table == torch.bfloat16)


@pytest.mark.parametrize("mode", ["piecewise", "gaussian"])
@pytest.mark.parametrize("width", KNOT_WIDTHS)
@pytest.mark.parametrize("n", KNOT_COUNTS)
def test_knots_segment_training_matches_plain(n, width, mode):
    """Rows 5-6 with n knots or Gaussians: SnakeAlt (segment_fwd /
    segment_fwd_tf) and ReLU (segment_fwd_anyg for the Gaussians) with
    segment_bwd: the image and every gradient leaf against the plain
    pair, one launch of each kernel."""
    needs_card()
    rs, rd = block_rays(32, "cuda")
    for net_kw in (dict(), dict(activation="ReLU")):
        net, tf, tf_kw = knots_case(width, n, mode == "gaussian", **net_kw)
        kw = dict(stepsize=1 / 64, max_steps=112, seg=32, tile=128,
                  differentiable=True)
        args = (rs, rd, net, *BOX)
        before = (fused_dvr_bwd.launches("segment_fwd_diff"),
                  fused_dvr_bwd.launches("segment_bwd"))
        img, got = tf_grads(fused_dvr.fused_trace_dvr, args, kw, tf, tf_kw)
        assert (fused_dvr_bwd.launches("segment_fwd_diff"),
                fused_dvr_bwd.launches("segment_bwd")) == (before[0] + 1,
                                                        before[1] + 1)
        img_plain, want = tf_grads(fused_dvr.fused_trace_dvr_plain, args,
                                   kw, tf, tf_kw)
        assert float(img_plain[:, 3].max()) > 0.5
        torch.testing.assert_close(img, img_plain, rtol=0, atol=ATOL)
        assert_grads_close(mode, got, want, {k: 1e-3 for k in want})
