"""The JAX package's TPU measurement probes: the CUDA kernels and their
plain PyTorch versions.

Counterparts of the kernels in ``tools/proto_mega.py`` (``kernel``, the
megakernel prototype) and ``tools/probe_lane_gather.py`` (the ``kern`` of
``probe_gather_single``, ``probe_gather_chunked`` and ``probe_onehot``).
Each wrapper launches ``csrc/probes.cu`` for CUDA tensors and runs its
plain version for CPU tensors; on a CUDA tensor it never falls back to the
plain version. The port's tools (``fvsrn_tpu_torch/tools/``) drive them.

- :func:`proto_mega`: a (T, S) grid of (128-ray tile, segment) programs;
  each sums a (BZ, BY, BX) box of ``tab`` at starts reduced from ray rows
  0-2 into the tile's (8, 128) output block and adds ones into the counts
  table at the same box. Returns (out (8, R), counts (Z, Y, X)). The
  kernel writes each cell's count (the boxes that cover it) whole, in two
  launches over the card: nothing is zeroed first.
- :func:`gather_single` / :func:`gather_chunked`: ``out[r, n] = tab[r,
  idx[r, n]]`` in float32, from a (rows, K) table (f32 or bf16 for the
  first; the second is the wide f32 table the TPU gathered in 128-column
  chunks). Indices outside [0, K) give 0.
- :func:`onehot_resolve`: the sub-box latent resolve ``out[:, n] =
  tab[lrow[n], :]`` from a bf16 (rows, C) table into float32 (C, N); 0 for
  a row outside the table (an all-zero one-hot column).
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import _build

# kernel launches since the last reset (the plain versions never count);
# one prototype launch is two kernels, proto_fill then proto_out
PROTO_LAUNCHES = 0
GATHER_SINGLE_LAUNCHES = 0
GATHER_CHUNKED_LAUNCHES = 0
ONEHOT_LAUNCHES = 0

TILE = 128            # rays per tile of the prototype
BOX = (6, 16, 256)    # the prototype's (BZ, BY, BX) slice
PROTO_CHUNK_ROWS = 8  # box rows of one partial sum (probes.cu kChunkRows)
PROTO_MAX_BOXES = 2048  # T * S boxes the kernel takes (probes.cu kMaxBoxes)


def reset_counts() -> None:
    global PROTO_LAUNCHES, GATHER_SINGLE_LAUNCHES, GATHER_CHUNKED_LAUNCHES
    global ONEHOT_LAUNCHES
    PROTO_LAUNCHES = GATHER_SINGLE_LAUNCHES = GATHER_CHUNKED_LAUNCHES = 0
    ONEHOT_LAUNCHES = 0


def counts() -> dict:
    return {"proto_mega": PROTO_LAUNCHES,
            "gather_single": GATHER_SINGLE_LAUNCHES,
            "gather_chunked": GATHER_CHUNKED_LAUNCHES,
            "onehot_resolve": ONEHOT_LAUNCHES}


def _check(dev, **tensors):
    for name, t in tensors.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


_FNS: dict = {}


def _bound(name: str, argtypes: str):
    """The entry point ``name`` of csrc/probes.cu, its arguments typed
    once: ``argtypes`` spells them, p a pointer and i an int."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("probes"), name)
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
        fn.argtypes = [kinds[c] for c in argtypes]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _raise(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _device(t: Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


# ---------------------------------------------------------------------------
# row 8: the megakernel prototype


def _proto_starts(r: Tensor, s: int, shape, box):
    """The (z, y, x) box start of one tile's rays ``r`` (8, 128) at
    segment ``s``: lane minima as float -> int32 (truncation), clipped as
    the TPU kernel clips them."""
    z, y, x = shape
    bz, by, bx = box
    zmin = min(max(int(r[0].min()) + s, 0), z - bz)
    ymin = min(max((int(r[1].min()) // 8) * 8, 0), y - by)
    xb = min(max(int(r[2].min()), 0), (x - bx) // 128)
    return zmin, ymin, xb * 128


def proto_mega_plain(rays: Tensor, tab: Tensor, n_seg: int = 3,
                     box=BOX) -> tuple[Tensor, Tensor]:
    """Plain version of :func:`proto_mega`: tiles and segments in a Python
    loop, the box summed by ``Tensor.sum``."""
    n_rays = rays.shape[1]
    out = torch.zeros_like(rays)
    cnt = torch.zeros_like(tab)
    bz, by, bx = box
    for t in range(n_rays // TILE):
        cols = slice(t * TILE, (t + 1) * TILE)
        r = rays[:, cols]
        for s in range(n_seg):
            z, y, x = _proto_starts(r, s, tab.shape, box)
            val = tab[z:z + bz, y:y + by, x:x + bx].sum()
            out[:, cols] += val + r
            cnt[z:z + bz, y:y + by, x:x + bx] += 1.0
    return out, cnt


def proto_mega(rays: Tensor, tab: Tensor, n_seg: int = 3,
               box=BOX) -> tuple[Tensor, Tensor]:
    """The prototype on (8, R) float32 rays (R a multiple of 128) and a
    (Z, Y, X) float32 table (X a multiple of 128). Returns (out (8, R),
    counts (Z, Y, X)). On the card the T = R / 128 tiles times ``n_seg``
    segments are at most PROTO_MAX_BOXES boxes: every block of the kernel
    holds all the box starts in shared memory."""
    if rays.ndim != 2 or rays.shape[0] != 8 or rays.shape[1] % TILE:
        raise ValueError(f"rays must be (8, R), R a multiple of {TILE}")
    if tab.ndim != 3 or any(b > d for b, d in zip(box, tab.shape)):
        raise ValueError(f"table {tuple(tab.shape)} smaller than the box")
    if _device(rays) == "cpu":
        return proto_mega_plain(rays, tab, n_seg, box)
    if rays.dtype != torch.float32 or tab.dtype != torch.float32:
        raise ValueError("proto_mega: float32 rays and table")
    if rays.shape[1] // TILE * n_seg > PROTO_MAX_BOXES:
        raise ValueError(f"proto_mega: {rays.shape[1] // TILE} tiles x "
                         f"{n_seg} segments, more than {PROTO_MAX_BOXES} "
                         "boxes")
    dev = rays.device
    _check(dev, rays=rays, tab=tab)
    out = torch.empty_like(rays)
    cnt = torch.empty_like(tab)
    # the kernel's partial box sums: PROTO_CHUNK_ROWS box rows an item
    items = -(-box[0] * box[1] // PROTO_CHUNK_ROWS)
    part = torch.empty(max(1, rays.shape[1] // TILE * n_seg * items),
                       dtype=torch.float32, device=dev)
    fn = _bound("proto_mega_launch", "pppppiiiiiiiiip")
    with torch.cuda.device(dev):
        err = fn(rays.data_ptr(), tab.data_ptr(), out.data_ptr(),
                 cnt.data_ptr(), part.data_ptr(), part.numel(),
                 rays.shape[1], n_seg, *tab.shape, *box, _stream(dev))
    _raise("proto_mega", err)
    global PROTO_LAUNCHES
    PROTO_LAUNCHES += 1
    return out, cnt


# ---------------------------------------------------------------------------
# rows 9-10: the lane-table gathers


def gather_single_plain(tab: Tensor, idx: Tensor) -> Tensor:
    """Plain version of :func:`gather_single`: ``torch.gather`` on the
    table read as float32."""
    return torch.gather(tab.to(torch.float32), 1, idx.to(torch.int64))


def gather_chunked_plain(tab: Tensor, idx: Tensor) -> Tensor:
    """Plain version of :func:`gather_chunked`, as the TPU computes it:
    128-column chunks, each a clipped gather masked to its own indices,
    summed."""
    idx = idx.to(torch.int64)
    tab = tab.to(torch.float32)
    acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for lo in range(0, tab.shape[1], 128):
        sub = tab[:, lo:lo + 128]
        local = torch.clamp(idx - lo, 0, sub.shape[1] - 1)
        got = torch.gather(sub, 1, local)
        inside = (idx >= lo) & (idx < lo + sub.shape[1])
        acc = acc + torch.where(inside, got, torch.zeros_like(got))
    return acc


def _gather_args(tab: Tensor, idx: Tensor):
    if tab.ndim != 2 or idx.ndim != 2 or idx.shape[0] != tab.shape[0]:
        raise ValueError("gather: tab (rows, K) and idx (rows, N)")
    if idx.dtype != torch.int32 or idx.shape[1] % 4:
        raise ValueError("gather: int32 indices, N a multiple of 4")
    dev = tab.device
    _check(dev, tab=tab, idx=idx)
    return dev, torch.empty(idx.shape, dtype=torch.float32, device=dev)


def gather_single(tab: Tensor, idx: Tensor) -> Tensor:
    """``out[r, n] = tab[r, idx[r, n]]`` as float32 from a float32 or bf16
    (rows, K) table and int32 (rows, N) indices in [0, K)."""
    if _device(tab) == "cpu":
        return gather_single_plain(tab, idx)
    if tab.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("gather_single: float32 or bf16 table")
    dev, out = _gather_args(tab, idx)
    fn = _bound("gather_single_launch", "piiippip")
    with torch.cuda.device(dev):
        err = fn(tab.data_ptr(), int(tab.dtype == torch.bfloat16),
                 tab.shape[0], tab.shape[1], idx.data_ptr(), out.data_ptr(),
                 idx.shape[1], _stream(dev))
    _raise("gather_single", err)
    global GATHER_SINGLE_LAUNCHES
    GATHER_SINGLE_LAUNCHES += 1
    return out


def gather_chunked(tab: Tensor, idx: Tensor) -> Tensor:
    """The same gather from a wide float32 (rows, K) table; indices
    outside [0, K) give 0."""
    if _device(tab) == "cpu":
        return gather_chunked_plain(tab, idx)
    if tab.dtype != torch.float32:
        raise ValueError("gather_chunked: float32 table")
    dev, out = _gather_args(tab, idx)
    fn = _bound("gather_chunked_launch", "piippip")
    with torch.cuda.device(dev):
        err = fn(tab.data_ptr(), tab.shape[0], tab.shape[1], idx.data_ptr(),
                 out.data_ptr(), idx.shape[1], _stream(dev))
    _raise("gather_chunked", err)
    global GATHER_CHUNKED_LAUNCHES
    GATHER_CHUNKED_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# row 11: the sub-box latent resolve


def onehot_resolve_plain(tab: Tensor, lrow: Tensor) -> Tensor:
    """Plain version of :func:`onehot_resolve`: the rows picked by index,
    read as float32, transposed; 0 for a row outside the table."""
    rows = lrow.reshape(-1).to(torch.int64)
    inside = (rows >= 0) & (rows < tab.shape[0])
    got = tab.to(torch.float32)[torch.clamp(rows, 0, tab.shape[0] - 1)]
    return torch.where(inside[:, None], got, torch.zeros_like(got)).T


def onehot_resolve(tab: Tensor, lrow: Tensor) -> Tensor:
    """``out[:, n] = tab[lrow[n], :]``: a bf16 (rows, C) table and int32
    (1, N) or (N,) row ids into float32 (C, N)."""
    if tab.ndim != 2 or lrow.numel() != lrow.shape[-1]:
        raise ValueError("onehot_resolve: tab (rows, C) and lrow (1, N)")
    if _device(tab) == "cpu":
        return onehot_resolve_plain(tab, lrow)
    if tab.dtype != torch.bfloat16 or lrow.dtype != torch.int32:
        raise ValueError("onehot_resolve: bf16 table and int32 row ids")
    if tab.shape[1] % 4:
        raise ValueError("onehot_resolve: C must be a multiple of 4")
    dev = tab.device
    _check(dev, tab=tab, lrow=lrow)
    n = lrow.numel()
    out = torch.empty(tab.shape[1], n, dtype=torch.float32, device=dev)
    fn = _bound("onehot_resolve_launch", "piippip")
    with torch.cuda.device(dev):
        err = fn(tab.data_ptr(), tab.shape[0], tab.shape[1], lrow.data_ptr(),
                 out.data_ptr(), n, _stream(dev))
    _raise("onehot_resolve", err)
    global ONEHOT_LAUNCHES
    ONEHOT_LAUNCHES += 1
    return out
