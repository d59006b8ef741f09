"""Host side of the training backwards' batched sample MLP
(fvsrn_tpu_torch/ops/sample_mlp.py, mirror of csrc/sample_mlp.cuh) and of
the forwards' warp-owned tiles (mirror of csrc/warp_mlp.cuh): the
three-pass TF32 split of the products' operands, the shared-memory plans
of a launch, and the sample evaluator's plan and persistent grid. The
device's own plans are held to this mirror on the card
(tests/test_torch_kernels.py::test_segment_bwd_smem_plan_matches_device,
::test_forward_smem_plans_match_device,
::test_sample_eval_plan_and_grid_match_device).
"""
import numpy as np
import pytest
import torch

from fvsrn_tpu_torch.ops import fused_dvr, fused_eval, fused_mega
from fvsrn_tpu_torch.ops.sample_mlp import (FWD_WARPS, SMEM_LIMIT, SMEM_TWO,
                                            TF_STAGED_POINTS, check_fwd_plan,
                                            check_plan, fwd_columns, fwd_plan,
                                            make_fwd_plan, make_plan,
                                            persistent_blocks, smem_plan,
                                            staged_tf_floats, tf32_split)


def _values(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(20000) * np.exp(rng.uniform(-30, 30, 20000))
    # the products' operands: normal floats, far from overflow (hi of the
    # largest float rounds to inf) and from the subnormals (lo loses bits)
    edge = [1.0, -1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, 3.0e30, -1.2e-30,
            1.0 - 2.0 ** -24, 2.0 ** -100 * (1.0 + 2.0 ** -11)]
    return torch.from_numpy(np.concatenate([x, edge]).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_split_round_trip(seed):
    """hi and lo are TF32 (low 13 mantissa bits zero) and hi + lo gives
    the float32 value back within 2^-22 of its magnitude."""
    x = _values(seed)
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # hi alone is the TF32 rounding: within half a TF32 ulp
    assert bool(((hi.double() - x.double()).abs()
                 <= 2.0 ** -11 * x.double().abs()).all())


def test_tf32_rounds_to_nearest_ties_away():
    """cvt.rna.tf32.f32: round to nearest, ties away from zero."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 1.5 * ulp], dtype=torch.float32)
    hi, _ = tf32_split(x)
    assert hi.tolist() == [one + ulp, -(one + ulp), one, one + 2 * ulp]


@pytest.mark.parametrize("hidden", [32, 48, 64])
def test_plan_fits_at_the_kernels_limits(hidden):
    """At the per-segment kernels' largest Fourier count, latent channels,
    hidden layers and staged TF points a plan fits in 227 KB."""
    k1 = 6 + 2 * fused_dvr.MAX_FOURIER + fused_dvr.MAX_LATENT_CHANNELS
    plan = smem_plan(hidden, k1, fused_dvr.MAX_HIDDEN_LAYERS,
                     fused_dvr.MAX_FOURIER, TF_STAGED_POINTS)
    assert plan is not None and plan.bytes <= SMEM_LIMIT
    assert plan.tile_rows in (16, 32, 48, 64) and plan.pad in (0, 8)
    assert check_plan("k", hidden, k1, fused_dvr.MAX_HIDDEN_LAYERS,
                      fused_dvr.MAX_FOURIER, TF_STAGED_POINTS) == plan


@pytest.mark.parametrize("case", ["segment_64_max", "segment_flagship",
                                  "mega_max"])
def test_plan_regions(case):
    """The tile and padding each width takes, and the regions' sum (hand
    counted from csrc/sample_mlp.cuh's make_plan): the flagship's widths
    take the largest tile with which an SM holds two blocks; the largest
    limits one block of 16 rows."""
    args, rows, pad, nbytes = {
        "segment_64_max": ((64, 134, 6, 32, 16), 16, 0, 223344),
        "segment_flagship": ((32, 50, 2, 14, 8), 64, 8, 113056),
        "mega_max": ((32, 83, 6, 32, 16), 16, 8, 101104)}[case]
    plan = smem_plan(*args)
    assert (plan.tile_rows, plan.pad, plan.bytes) == (rows, pad, nbytes)
    assert all(v % 4 == 0 for v in plan.regions.values())
    assert (plan.bytes <= SMEM_TWO) == (case != "segment_64_max")
    assert plan.regions["hreg"] >= plan.regions["X"]
    # phase B keeps the alpha entering each (ray, sample) over dact + hreg
    assert plan.regions["dact"] + plan.regions["hreg"] >= 32 * 32


@pytest.mark.parametrize("beyond", [dict(n_hidden=7), dict(n_fourier=48),
                                    dict(k_extra=32)])
def test_plan_raises_beyond_the_limits(beyond):
    """Past the limits at width 64 no plan fits: check_plan raises."""
    nf = beyond.get("n_fourier", 32)
    nh = beyond.get("n_hidden", 6)
    k1 = 6 + 2 * nf + 64 + beyond.get("k_extra", 0)
    assert smem_plan(64, k1, nh, nf, 16) is None
    with pytest.raises(NotImplementedError):
        check_plan("segment backward kernel", 64, k1, nh, nf, 16)
    assert make_plan(64, k1, nh, nf, 16, 16, 0).bytes > SMEM_LIMIT


@pytest.mark.parametrize("hidden", [32, 48, 64])
def test_fwd_plan_fits_at_the_kernels_limits(hidden):
    """At the per-segment kernel's largest Fourier count, latent rows,
    hidden layers and staged TF points the forward's plan fits in 227 KB,
    with fewer warps a block and the matrices split in the loop."""
    plan = fwd_plan(hidden, fused_dvr.MAX_FOURIER,
                    fused_dvr.MAX_LATENT_CHANNELS // 16,
                    fused_dvr.MAX_HIDDEN_LAYERS, TF_STAGED_POINTS,
                    direction=True)
    assert plan is not None and plan.bytes <= SMEM_LIMIT
    assert plan.warps in FWD_WARPS and not plan.pre
    assert check_fwd_plan("k", hidden, fused_dvr.MAX_FOURIER,
                          fused_dvr.MAX_LATENT_CHANNELS // 16,
                          fused_dvr.MAX_HIDDEN_LAYERS,
                          TF_STAGED_POINTS, direction=True) == plan
    # the flagship's other widths: 16 warps an SM (two blocks) at 32,
    # pre-split, and at 48, split in the loop; 8 at 64, pre-split
    flagship = fwd_plan(hidden, 14, 1, 2, 8)
    assert flagship.warps == 8 and flagship.pre == (hidden != 48)
    assert (flagship.bytes <= SMEM_TWO) == (hidden != 64)
    # the megakernel's block is its 256-ray tile: eight warps at its limits
    mega = fwd_plan(32, fused_mega.MAX_FOURIER, 1,
                    fused_mega.MAX_HIDDEN_LAYERS, TF_STAGED_POINTS,
                    warps=8)
    assert mega is not None and mega.warps == 8


@pytest.mark.parametrize("case", ["flagship", "flagship_dir",
                                  "segment_64_max", "mega_max"])
def test_fwd_plan_regions(case):
    """The warps and bytes each width takes (hand counted from
    csrc/warp_mlp.cuh's make_fwd_plan), and the tile row's width."""
    args, warps, pre, nbytes, k = {
        "flagship": ((32, 14, 1, 2, 8, None, False), 8, True, 95664, 48),
        "flagship_dir": ((32, 14, 1, 2, 8, None, True), 8, True, 105904,
                         56),
        "segment_64_max": ((64, 32, 4, 6, 16, None, True), 4, False,
                           231504, 136),
        "mega_max": ((32, 32, 1, 6, 16, 8, False), 8, True, 180688,
                     88)}[case]
    plan = fwd_plan(*args)
    assert (plan.warps, plan.pre, plan.bytes) == (warps, pre, nbytes)
    assert fwd_columns(args[1], args[2], args[6]) == k and k % 8 == 0
    assert all(v % 4 == 0 for v in plan.regions.values())
    # a row, its head outputs (4) and its ray's fields (8)
    assert plan.regions["tiles"] == warps * 32 * (max(k, args[0]) + 16)


@pytest.mark.parametrize("beyond", [dict(n_hidden=12), dict(n_fourier=256)])
def test_fwd_plan_raises_beyond_the_limits(beyond):
    """Past the limits at width 64 no plan fits, not even one warp a
    block: check_fwd_plan raises."""
    nf = beyond.get("n_fourier", 32)
    nh = beyond.get("n_hidden", 6)
    assert fwd_plan(64, nf, 4, nh, 16, direction=True) is None
    with pytest.raises(NotImplementedError):
        check_fwd_plan("segment kernel", 64, nf, 4, nh, 16, direction=True)
    assert make_fwd_plan(64, nf, 4, nh, 16, 1, False, True).bytes \
        > SMEM_LIMIT


@pytest.mark.parametrize("hidden", [32, 48, 64])
def test_eval_plan_fits_at_the_kernels_limits(hidden):
    """The sample evaluator's plan (the forwards' plan with no TF points)
    fits in 227 KB at its limits: 32 Fourier features, its 16 latent
    channels (one table row), the most hidden layers, direction input."""
    plan = fused_eval.eval_plan(hidden, fused_dvr.MAX_FOURIER, 1,
                                fused_dvr.MAX_HIDDEN_LAYERS, True)
    assert plan.bytes <= SMEM_LIMIT and plan.warps in FWD_WARPS
    assert plan == fwd_plan(hidden, fused_dvr.MAX_FOURIER, 1,
                            fused_dvr.MAX_HIDDEN_LAYERS, 0, direction=True)


@pytest.mark.parametrize("case", ["flagship", "flagship_48", "limits_64"])
def test_eval_plan_regions(case):
    """The evaluator's regions, hand counted from what csrc/sample_eval.cu
    reads (warp_mlp.cuh's make_fwd_plan with no TF block): the first
    layer's K rows and the hidden matrices (pre-split: 2 H floats a row;
    else H + 8), the vectors (b1, the hidden biases, Wo (4, H), bo, B and
    Bd padded to 4 rows, no TF), and a warp's tile of 32 rows of max(K, H)
    + 4 floats, 32 head rows of 4 and 32 ray rows of 8."""
    args, warps, pre, regions = {
        # K 48: 32 Fourier columns, 16 latent, 3 position, 5 zeros
        "flagship": ((32, 14, 1, 2, False), 8, True, dict(
            W1=48 * 64, Wh=2 * 32 * 64, vec=32 + 64 + 128 + 4 + 96,
            tiles=8 * 32 * (52 + 12))),
        # pre-split, 8 warps fit one block an SM; split in the loop, two
        "flagship_48": ((48, 14, 1, 2, False), 8, False, dict(
            W1=48 * 56, Wh=2 * 48 * 56, vec=48 + 96 + 192 + 4 + 96,
            tiles=8 * 32 * (52 + 12))),
        # K 88: 64 Fourier columns, 16 latent, 6 position and direction
        "limits_64": ((64, 32, 1, 6, True), 4, False, dict(
            W1=88 * 72, Wh=6 * 64 * 72, vec=64 + 384 + 256 + 4 + 192,
            tiles=4 * 32 * (92 + 12)))}[case]
    plan = fused_eval.eval_plan(*args)
    assert (plan.warps, plan.pre, plan.regions) == (warps, pre, regions)
    assert plan.bytes == 4 * sum(regions.values())
    assert (plan.bytes <= SMEM_TWO) == (case != "limits_64")


@pytest.mark.parametrize("case", [
    ("flagship", 0, 132, 0), ("flagship", 1, 132, 1),
    ("flagship", 256, 132, 1), ("flagship", 257, 132, 2),
    ("flagship", 2 ** 18, 132, 264), ("flagship", 2 ** 18 + 7, 132, 264),
    ("flagship", 2 ** 18, 2, 4), ("limits_64", 129, 132, 2),
    ("limits_64", 2 ** 18, 132, 132)])
def test_persistent_blocks(case):
    """The evaluator's persistent grid: min(the call's blocks of tiles,
    the blocks the SMs hold resident). The flagship's plan takes 8 tiles a
    block, two blocks an SM; the plan at the limits 4 tiles, one."""
    plan_case, n, sms, blocks = case
    plan = fused_eval.eval_plan(*{"flagship": (32, 14, 1, 2, False),
                                  "limits_64": (64, 32, 1, 6, True)}[
                                      plan_case])
    assert persistent_blocks(n, plan, sms) == blocks


# the shapes the plan tests cover: this file's, the device plans'
# (tests/test_torch_kernels.py) and Table 1's (tests/
# test_torch_wide_networks.py); forwards as (hidden, Fourier, latent rows,
# hidden->hidden layers, warps or None, direction), backwards as (hidden,
# first-layer input, hidden->hidden layers, Fourier)
def _covered_shapes():
    fwd, bwd = set(), set()
    for h in (32, 48, 64, 128):
        for d in (False, True):
            fwd |= {(h, 32, 4, 6, None, d), (h, 14, 1, 2, None, d)}
            fwd |= {(h, nf, 1, nh, 8, d) for nf, nh in
                    ((14, 2), (32, 6), (0, 0))}
        fwd |= {(h, 14, 1, nh, 8, False) for nh in (1, 3, 5)}
        bwd |= {(h, 6 + 2 * nf + 16 * c, nh, nf)
                for nf, c, nh in ((14, 1, 2), (32, 4, 6))}
        bwd |= {(h, 47, nh, 14) for nh in (1, 3, 5)}
    bwd |= {(64, 134, 6, 32), (32, 50, 2, 14), (32, 83, 6, 32)}
    return sorted(fwd, key=str), sorted(bwd)


def _plans(points, per):
    """Each covered shape's plans at ``points`` TF points of ``per``
    floats (5 a piecewise knot, 6 a Gaussian, the TF modes' state with
    the Gaussians): the forwards' (warps, pre-split, blocks an SM), the
    backwards' (tile rows, padding, blocks an SM); None where none
    fits."""
    fwd, bwd = _covered_shapes()
    keys = []
    for h, nf, ch, nh, w, d in fwd:
        p = fwd_plan(h, nf, ch, nh, points, w, d, per * points)
        keys.append(p and (p.warps, p.pre, p.bytes <= SMEM_TWO))
    for h, k1, nh, nf in bwd:
        p = smem_plan(h, k1, nh, nf, points, per * points, per == 6)
        keys.append(p and (p.tile_rows, p.pad, p.bytes <= SMEM_TWO))
    return keys


@pytest.mark.parametrize("per", [5, 6])
def test_tf_staged_points_keep_every_plan(per):
    """TF_STAGED_POINTS is the largest count at which every covered
    shape's plans are its 16-point plans, piecewise knots and Gaussians:
    every count up to it gives them, one more changes one."""
    want = _plans(16, per)
    for points in range(17, TF_STAGED_POINTS + 1):
        assert _plans(points, per) == want, points
    if per == 5:    # the knots' 20th moves a 128-wide backward's padding
        assert _plans(TF_STAGED_POINTS + 1, per) != want


def test_staged_tf_floats():
    """Up to TF_STAGED_POINTS knots or Gaussians the plans count the TF,
    above none of it; the texture modes' tables always; the device's
    constant is the same."""
    s = TF_STAGED_POINTS
    assert staged_tf_floats("piecewise", 5 * s) == 5 * s
    assert staged_tf_floats("piecewise", 5 * s + 5) == 0
    assert staged_tf_floats("gaussian", 6 * s) == 6 * s
    assert staged_tf_floats("gaussian", 6 * s + 6) == 0
    assert staged_tf_floats("texture", 4 * 1024) == 4 * 1024
    assert staged_tf_floats("preint2d", 0) == 0
    header = (fused_dvr._build.CSRC_DIR + "/march_common.cuh")
    with open(header) as f:
        assert f"constexpr int kTfStaged = {s};" in f.read()
    # above it the plan is the plan of no TF
    assert fwd_plan(32, 14, 1, 2, s + 1, 8, False,
                    staged_tf_floats("piecewise", 5 * s + 5)) \
        == fwd_plan(32, 14, 1, 2, 0, 8, False, 0)
