"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the megakernel's render forward, its differentiable forward
(image, stored carries, segments visited) and backward (every gradient
leaf, also with no latent grid and with a TF whose first knot absorbs),
the per-segment engine (csrc/segment_fwd.cu: every network and option it
takes, image, samples and the call's stop) and its differentiable pair
(csrc/segment_fwd.cu storing carries, csrc/segment_bwd.cu: image and
every gradient leaf over the same networks and options) and the sample
evaluator (csrc/sample_eval.cu: density and its position gradient at
scattered positions), the occupancy mask in all three megakernel
launches, and the probe kernels of rows 8-11 (csrc/probes.cu). This file
imports no JAX, so it runs where the GPU is:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which the GPU
machine does not have). Without a card the kernel tests skip; the
checks of what the kernel takes run anywhere.
"""
import math

import numpy as np
import pytest
import torch

from fvsrn_tpu_torch.camera import CameraOnASphere, generate_rays
from fvsrn_tpu_torch.convert import srn_from_arrays
from fvsrn_tpu_torch.inference import pad_rays
from fvsrn_tpu_torch.ops import (fused_dvr, fused_dvr_bwd, fused_eval,
                                 fused_mega)
from fvsrn_tpu_torch.ops.fused_dvr import block_ray_permutation
from fvsrn_tpu_torch.scenes import dense_scene
from fvsrn_tpu_torch.train.checkpoints import load_weights
from fvsrn_tpu_torch.transfer import TransferFunctionPiecewiseLinear

torch.set_num_threads(1)
ATOL = 1e-4       # float32 kernel vs plain: the fused-vs-oracle contract
BOX = ((-0.5, -0.5, -0.5), (1.0, 1.0, 1.0))


def random_net(seed=3, activation="SnakeAlt", output_mode="density:direct",
               channels=8, fourier=6, width=32, out_bias=0.4, direction=False):
    """A 3-hidden-layer SRN with torch Linear-style random weights; no
    latent grid with ``channels=0``. ``out_bias`` sets the density's
    level (0.4 a visible density, 0.0 clips about half the samples at
    0); ``direction`` adds the ray direction to the input and to the
    Fourier features."""
    rng = np.random.default_rng(seed)
    n_out_head = 1 if output_mode.startswith("density") else 4
    n_in = 6 if direction else 3
    sizes = [n_in + 2 * fourier + channels, width, width, width, n_out_head]
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
        layers.append({"activation": activation if i < 3 else "None",
                       "activation_param": 2.0})
    if n_out_head == 1:
        arrays["layers.3.bias"] = np.asarray([out_bias])
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
    before = fused_mega.LAUNCHES
    got, samples = fused_mega.mega_trace_dvr(*args, **kw)
    torch.cuda.synchronize()
    assert fused_mega.LAUNCHES == before + 1
    want, samples_plain = fused_mega.mega_trace_dvr_plain(*args, **kw)
    assert fused_mega.LAUNCHES == before + 1
    assert float(want[:, 3].max()) > 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    assert torch.equal(samples.long(), samples_plain)


def case_net(which):
    """The network of a card case: "random", "nogrid" (random, without a
    latent grid) or "flagship"."""
    _, _, npz = dense_scene()
    if which == "flagship":
        return load_weights(npz).cuda()
    return random_net(channels=0 if which == "nogrid" else 8).cuda()


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
            rays, fused_mega._pack_weights(params),
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
        before = fused_mega.BWD_LAUNCHES
        img, _ = fn.apply(rays, spec, mask,
                          *fused_mega._params(net, tf_leaf))
        (img * w).sum().backward()
        torch.cuda.synchronize()
        launched = fused_mega.BWD_LAUNCHES - before
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


def random_mask(rays, spec, seed=2):
    """A seeded occupancy mask culling about a third of the (tile,
    segment) programs."""
    n_seg = fused_mega.segments_needed(rays, spec)
    keep = torch.rand(rays.shape[0] // 256, n_seg, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(seed))
    return fused_mega._check_mask(keep > 0.33, rays.shape[0] // 256,
                                  rays.device)


@pytest.mark.parametrize("which", ["random", "flagship"])
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
            rays, fused_mega._pack_weights(params),
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


@pytest.mark.parametrize("net_kw,tile", [
    (dict(activation="ReLU"), 256), (dict(output_mode="density"), 256),
    (dict(channels=20), 256), (dict(width=16), 256), ({}, 64)])
def test_mega_kernel_rejects_what_it_does_not_take(net_kw, tile):
    rays = torch.zeros(512, 8)
    with pytest.raises(NotImplementedError):
        fused_mega._check_kernel_inputs(random_net(**net_kw), rays, tile)
    fused_mega._check_kernel_inputs(random_net(), rays, 256)
    fused_mega._check_kernel_inputs(random_net(channels=0), rays, 256)


@pytest.mark.parametrize("case", ["ray_grads", "seg"])
def test_mega_backward_rejects_what_it_does_not_take(case):
    """The backward kernel takes no ray gradients and 32-point segments."""
    rays = torch.zeros(512, 8, requires_grad=(case == "ray_grads"))
    seg = 16 if case == "seg" else 32
    with pytest.raises(NotImplementedError):
        fused_mega._check_kernel_inputs(random_net(), rays, 256, seg,
                                        differentiable=True)
    fused_mega._check_kernel_inputs(random_net(), rays.detach(), 256, 32,
                                    differentiable=True)


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


@pytest.mark.parametrize("net_kw", [dict(width=96), dict(channels=80)])
def test_segment_kernel_rejects_what_it_does_not_take(net_kw):
    tf = dense_scene()[1].tensor
    with pytest.raises(NotImplementedError):
        fused_dvr._check_kernel_inputs(random_net(**net_kw), tf)
    fused_dvr._check_kernel_inputs(random_net(width=64, channels=40), tf)


# the per-segment engine's differentiable pair over SEGMENT_CASES: a float32
# table (the bf16 cases train on float32), no iso march
SEGMENT_GRAD_CASES = sorted(set(SEGMENT_CASES) - {"flagship_bf16_table",
                                                  "iso"})


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
    rs, rd, _ = pad_rays(rs.reshape(-1, 3), rd.reshape(-1, 3), kw["tile"])
    w = torch.empty(rs.shape[0], 4, device="cuda").uniform_(
        -1, 1, generator=torch.Generator("cuda").manual_seed(1))
    got = {}
    for fn in (fused_dvr.fused_trace_dvr, fused_dvr.fused_trace_dvr_plain):
        net.zero_grad(set_to_none=True)
        tf_leaf = tf.tensor.cuda().requires_grad_(True)
        before = (fused_dvr_bwd.SEGMENT_DIFF_LAUNCHES,
                  fused_dvr_bwd.SEGMENT_BWD_LAUNCHES)
        img = fn(rs, rd, net, *BOX, tf_leaf, **kw)
        (img * w).sum().backward()
        torch.cuda.synchronize()
        launched = (fused_dvr_bwd.SEGMENT_DIFF_LAUNCHES - before[0],
                    fused_dvr_bwd.SEGMENT_BWD_LAUNCHES - before[1])
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


@pytest.mark.parametrize("want_grad", [False, True])
@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sample_eval_kernel_matches_plain(case, want_grad):
    """Row 7: the sample evaluator against its plain version on 5000
    positions (not a multiple of the block) with 20% spill past the box
    and unit directions: values <= 1e-4, the inside mask equal, and the
    position gradient within a relative norm error of 1e-3 on interior
    positions. One launch a call, none by the plain version."""
    needs_card()
    spec = SAMPLE_CASES[case]
    _, _, npz = dense_scene()
    net = (load_weights(npz) if spec["net"] == "flagship"
           else random_net(**spec["net"])).cuda()
    table_dtype = spec.get("table_dtype", torch.float32)
    gen = torch.Generator("cuda").manual_seed(0)
    pos = torch.rand(5000, 3, device="cuda", generator=gen) * 1.4 - 0.7
    d = torch.randn(5000, 3, device="cuda", generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
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
        assert rel_err(got[2][inner], grad[inner]) <= 1e-3
