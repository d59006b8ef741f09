"""Host side of the batched sample MLP (``csrc/sample_mlp.cuh``), the
device layer both training backwards (``csrc/segment_bwd.cu``,
``csrc/mega_bwd.cu``) compute their network products on, and of the
warp-owned sample tile (``csrc/warp_mlp.cuh``) both forward marches
(``csrc/segment_fwd.cu``, ``csrc/mega_fwd.cu``) evaluate on.

- :func:`tf32_split`: the three-pass TF32 split the kernels apply to every
  product operand (``split`` in the header): ``x = hi + lo``, both
  rounded to TF32 (10 explicit mantissa bits, round to nearest, ties away
  from zero, as ``cvt.rna.tf32.f32``), so that ``hi*hi' + hi*lo' +
  lo*hi'`` carries a float32 product to within about 2^-21.
- :func:`smem_plan`: the shared-memory plan a launch takes (``make_plan``
  and ``choose_plan`` in the header): region sizes in floats, the tile's
  rows M (64, 48, 32 or 16) and the weight rows' padding: the largest
  with which an SM holds two blocks, else the largest that fits in the
  227 KB a block may use; :func:`check_plan` raises for
  widths no plan fits.
- :func:`fwd_plan`: the forwards' shared-memory plan (``make_fwd_plan``
  and ``choose_fwd_plan`` in warp_mlp.cuh): the layer matrices in the
  tile's column order (pre-split into TF32 hi and lo where that fits),
  the vectors, then per warp a tile of 32 rows (each row, its head
  outputs and its ray's fields), with the most warps an SM holds;
  :func:`check_fwd_plan` raises for widths no plan fits. The sample
  evaluator (``csrc/sample_eval.cu``) takes the same plan with no TF
  points.
- :func:`persistent_blocks`: the blocks of a persistent launch over
  independent rows (``persistent_blocks`` in warp_mlp.cuh), the sample
  evaluator's grid.

Both plans have a wide form for hidden widths above
:data:`SMEM_MAX_WIDTH` (the 128 instances): the hidden matrices are not
staged (a 128 x 128 float32 matrix takes 69.6 KB with its padded rows,
eight warps' forward tiles 147 KB of the 227 KB); the kernels read them
from the packed weights in device memory, where they stay in L2, and
stage the first layer and the vectors only.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

SMEM_LIMIT = 232448      # bytes of shared memory a block may use (227 KB)
SMEM_TWO = 115712        # bytes each of two blocks an SM holds
GROUP = 32               # rays of a group (one warp's lanes)
SEG_MAX = 32             # samples per segment
SMEM_MAX_WIDTH = 64      # the widest hidden layer staged in shared memory
ROW_FLOATS = 24          # per-row scalars of a tile
RAY_FLOATS = 12          # per-ray scalars a kernel stages
# the plans tried, in order: (tile rows, weight-row padding)
CANDIDATES = ((64, 8), (48, 8), (32, 8), (16, 8), (16, 0))
# per-(ray, sample) state of the TF modes other than piecewise: color and
# absorption (then their cotangents), density, its cotangent; a density a
# ray (csrc/sample_mlp.cuh's kScTf)
SC_TF = 4 * GROUP * SEG_MAX + GROUP


# piecewise knots or Gaussians the kernels stage in shared memory
# (csrc/march_common.cuh's kTfStaged): the largest count at which every
# plan that tests/test_torch_sample_mlp.py covers is its 16-point plan
# (tile rows, padding, pre-split, warps and blocks an SM). A larger TF is
# read from the packed weights in device memory, and the plans count none
# of it, so that no count changes them.
TF_STAGED_POINTS = 19
_FLOATS_A_POINT = {"piecewise": 5, "gaussian": 6}


def staged_tf_floats(tf_mode: str, tf_floats: int) -> int:
    """Of a TF's ``tf_floats`` packed floats (:func:`tf_floats_of`), those
    the kernels stage in shared memory (``staged_tf_floats`` in
    csrc/march_common.cuh): none of a piecewise or Gaussian TF above
    :data:`TF_STAGED_POINTS` points, else all."""
    per = _FLOATS_A_POINT.get(tf_mode)
    return 0 if per and tf_floats > per * TF_STAGED_POINTS else tf_floats


def tf_floats_of(tf_mode: str, table) -> int:
    """Floats of the TF the kernels stage (and pack): 5 a piecewise knot,
    the table of the other modes, none of the preint2d table (read from
    L2). ``table`` is ``ops.fused_dvr.prepare_tf``'s."""
    return 0 if tf_mode == "preint2d" else int(table.numel())


def _round_tf32(x: Tensor) -> Tensor:
    """float32 -> TF32 (low 13 mantissa bits zero), round to nearest with
    ties away from zero; inf and NaN pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    sign = bits & ~0x7FFFFFFF
    mag = (bits & 0x7FFFFFFF) + 0x1000          # half of the dropped ulp
    rounded = sign | (mag & ~0x1FFF)
    return torch.where(finite, rounded, bits).view(torch.float32)


def tf32_split(x: Tensor) -> tuple[Tensor, Tensor]:
    """(hi, lo), both TF32, with hi + lo within 2^-22 |x| of float32 x."""
    x = x.to(torch.float32)
    hi = _round_tf32(x)
    return hi, _round_tf32(x - hi)


def _take(n: int) -> int:
    return (n + 3) // 4 * 4


@dataclass(frozen=True)
class Plan:
    tile_rows: int
    pad: int
    regions: dict
    wide: bool = False          # the hidden matrices in device memory

    @property
    def floats(self) -> int:
        return sum(self.regions.values())

    @property
    def bytes(self) -> int:
        return 4 * self.floats


def wide_width(hidden: int) -> bool:
    """Whether ``hidden`` takes the wide plans (``wide_width`` in
    csrc/sample_mlp.cuh)."""
    return hidden > SMEM_MAX_WIDTH


def make_plan(hidden: int, k1: int, n_hidden: int, n_fourier: int,
              tf_points: int, tile_rows: int, pad: int,
              tf_floats: int | None = None, tf_state: bool = False) -> Plan:
    """The regions (floats, each rounded up to 4) of one tile size;
    ``tf_floats`` staged TF floats (default 5 a piecewise knot),
    ``tf_state`` the TF modes' per-sample state; above
    :data:`SMEM_MAX_WIDTH` the hidden matrices take no room (the wide
    plan)."""
    r16 = -(-k1 // 16) * 16
    ldx, lda, ldw = r16 + 4, hidden + 4, hidden + pad
    tfn = 5 * tf_points if tf_floats is None else tf_floats
    n_vec = (hidden + n_hidden * hidden + 4 * hidden + 4 + 6 * n_fourier
             + tfn)
    acts = (n_hidden + 1) * tile_rows * lda
    regions = dict(
        W1=r16 * ldw, Wh=n_hidden * hidden * ldw, vec=n_vec,
        X=tile_rows * ldx, dact=acts, hreg=max(acts, tile_rows * ldx),
        rows=tile_rows * ROW_FLOATS,
        sc=SC_TF if tf_state else 2 * GROUP * SEG_MAX,
        sray=GROUP * RAY_FLOATS, masks=4 * GROUP, list=GROUP * SEG_MAX // 2,
        misc=8)
    if wide_width(hidden):
        regions["Wh"] = 0
    return Plan(tile_rows, pad, {k: _take(v) for k, v in regions.items()},
                wide_width(hidden))


def smem_plan(hidden: int, k1: int, n_hidden: int, n_fourier: int,
              tf_points: int, tf_floats: int | None = None,
              tf_state: bool = False) -> Plan | None:
    """The first of :data:`CANDIDATES` with which an SM holds two blocks,
    else the first that fits one, or None."""
    for limit in (SMEM_TWO, SMEM_LIMIT):
        for rows, pad in CANDIDATES:
            plan = make_plan(hidden, k1, n_hidden, n_fourier, tf_points,
                             rows, pad, tf_floats, tf_state)
            if plan.bytes <= limit:
                return plan
    return None


def check_plan(kernel: str, hidden: int, k1: int, n_hidden: int,
               n_fourier: int, tf_points: int, tf_floats: int | None = None,
               tf_state: bool = False) -> Plan:
    """:func:`smem_plan`, raising ``NotImplementedError`` when none fits."""
    plan = smem_plan(hidden, k1, n_hidden, n_fourier, tf_points, tf_floats,
                     tf_state)
    if plan is None:
        raise NotImplementedError(
            f"{kernel}: no shared-memory plan fits in {SMEM_LIMIT} bytes for "
            f"width {hidden}, first-layer input {k1}, {n_hidden} hidden "
            f"layers, {n_fourier} Fourier features, {tf_points} TF points")
    return plan


# the forwards' warp-owned tiles (csrc/warp_mlp.cuh)
FWD_ROWS = 32                 # rows of a tile: one a lane
FWD_WARPS = (8, 4, 2, 1)      # warps a block, in the order tried


def fwd_columns(n_fourier: int, chunks: int, direction: bool = False) -> int:
    """Width K of a tile row: cos and sin of the Fourier features, the
    latent rows, the position, the direction (with direction input),
    zeros up to a multiple of 8."""
    used = 2 * n_fourier + 16 * chunks + (6 if direction else 3)
    return -(-used // 8) * 8


@dataclass(frozen=True)
class FwdPlan:
    warps: int
    pre: bool
    regions: dict
    wide: bool = False          # the hidden matrices in device memory

    @property
    def floats(self) -> int:
        return sum(self.regions.values())

    @property
    def bytes(self) -> int:
        return 4 * self.floats


def make_fwd_plan(hidden: int, n_fourier: int, chunks: int, n_hidden: int,
                  tf_points: int, warps: int, pre: bool,
                  direction: bool = False,
                  tf_floats: int | None = None) -> FwdPlan:
    """The regions (floats, each rounded up to 4) of a block of ``warps``
    warps; with ``pre`` the layer matrices pre-split (hi and lo, two
    floats an entry), else rows padded to ``hidden + 8``; ``tf_floats``
    staged TF floats (default 5 a piecewise knot); above
    :data:`SMEM_MAX_WIDTH` the hidden matrices take no room (the wide
    plan)."""
    f4 = -(-n_fourier // 4) * 4
    k = fwd_columns(n_fourier, chunks, direction)
    ldw, lds = hidden + 8, max(k, hidden) + 4
    per = 2 * hidden if pre else ldw
    regions = dict(
        W1=k * per, Wh=0 if wide_width(hidden) else n_hidden * hidden * per,
        vec=(hidden + n_hidden * hidden + 4 * hidden + 4 + 6 * f4
             + (5 * tf_points if tf_floats is None else tf_floats)),
        tiles=warps * FWD_ROWS * (lds + 4 + 8))
    return FwdPlan(warps, pre, {k: _take(v) for k, v in regions.items()},
                   wide_width(hidden))


def fwd_plan(hidden: int, n_fourier: int, chunks: int, n_hidden: int,
             tf_points: int, warps: int | None = None,
             direction: bool = False,
             tf_floats: int | None = None) -> FwdPlan | None:
    """The plan with the most warps an SM holds (warps a block, from
    :data:`FWD_WARPS` or only ``warps``, times the blocks its shared
    memory holds, two or one), the first of those with pre-split
    matrices (never in the wide plan, whose first layer is split in the
    loop as its hidden matrices are), then with the most warps a block;
    None when none fits."""
    best, plan = 0, None
    for w in FWD_WARPS:
        if warps is not None and w != warps:
            continue
        for pre in (False,) if wide_width(hidden) else (True, False):
            cand = make_fwd_plan(hidden, n_fourier, chunks, n_hidden,
                                 tf_points, w, pre, direction, tf_floats)
            blocks = (2 if cand.bytes <= SMEM_TWO
                      else 1 if cand.bytes <= SMEM_LIMIT else 0)
            if w * blocks > best:
                best, plan = w * blocks, cand
    return plan


def check_fwd_plan(kernel: str, hidden: int, n_fourier: int, chunks: int,
                   n_hidden: int, tf_points: int, warps: int | None = None,
                   direction: bool = False,
                   tf_floats: int | None = None) -> FwdPlan:
    """:func:`fwd_plan`, raising ``NotImplementedError`` when none
    fits."""
    plan = fwd_plan(hidden, n_fourier, chunks, n_hidden, tf_points, warps,
                    direction, tf_floats)
    if plan is None:
        raise NotImplementedError(
            f"{kernel}: no shared-memory plan fits in {SMEM_LIMIT} bytes for "
            f"width {hidden}, {n_fourier} Fourier features, {chunks} latent "
            f"rows, {n_hidden} hidden layers, {tf_points} TF points")
    return plan


def persistent_blocks(n: int, plan: FwdPlan, sms: int) -> int:
    """Blocks of a persistent launch over ``n`` independent rows, in tiles
    of 32 rows, ``plan.warps`` tiles at a time a block: the blocks ``sms``
    SMs hold resident (two an SM when each fits in half its shared
    memory, else one, as :func:`fwd_plan` counts them), or fewer when the
    call has fewer tiles."""
    tiles = -(-n // FWD_ROWS)
    per_sm = 2 if plan.bytes <= SMEM_TWO else 1
    return min(-(-tiles // plan.warps), per_sm * sms)
