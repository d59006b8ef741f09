"""Process groups, ranks and their devices: the data-parallel mesh.

Counterpart of ``fvsrn_tpu/parallel/mesh.py``. The JAX package runs one
process over N devices and shards arrays over a mesh axis; the PyTorch
idiom is one process a rank, joined by ``torch.distributed``. A
:class:`Mesh` is this process's place in the group: its rank, the world
size, its device and the backend.

- :func:`make_mesh` joins a process group or starts one. Under
  ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` set) it joins
  through the environment; otherwise through a ``file://`` store, so that
  no port and no network is needed (one rank makes its own; more ranks
  are started by :func:`spawn`, which hands each its rank and the store).
- Each rank's device is explicit: ``cuda:(local_rank % device_count)``,
  or the CPU when asked.
- The backend is stated, not guessed (:func:`choose_backend`): ``nccl``
  when every rank of the host has a card of its own, ``gloo`` when ranks
  share a card or run on the CPU. NCCL refuses two ranks on one device,
  so asking for it there raises.
- :func:`shard_batch` takes the rank's slice of the leading axis,
  :func:`gather_batch` concatenates every rank's slices back in rank
  order on every rank, :func:`replicate` broadcasts a module's weights
  from rank 0.

Collectives on CUDA tensors: ``gloo`` takes them for ``broadcast`` and
``all_reduce`` (it stages them through host memory itself) and for
``all_gather`` too (its CUDA all-gather work); ``nccl`` takes only CUDA
tensors.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from ..utils.device import resolve_device

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(seconds=600)
RESULT_FILE = "rank0_result.pt"
_OWN_STORES: list = []


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group."""
    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes files and prints."""
        return self.rank == 0


def choose_backend(device_type: str, local_world_size: int,
                   device_count: int, backend: Optional[str] = None) -> str:
    """The backend of ``local_world_size`` ranks on one host with
    ``device_count`` cards: ``nccl`` when each CUDA rank has a card of its
    own, ``gloo`` when they share one or run on the CPU. An explicit
    ``backend`` is checked against the same facts: ``nccl`` on the CPU or
    with two ranks on one card raises ``ValueError``."""
    own_card = device_type == "cuda" and local_world_size <= device_count
    if backend is None:
        return "nccl" if own_card else "gloo"
    if backend == "nccl" and not own_card:
        where = ("the CPU" if device_type != "cuda" else
                 f"{local_world_size} ranks on {device_count} card(s)")
        raise ValueError(f"nccl needs a card per rank, not {where}; use "
                         "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def under_torchrun() -> bool:
    """Whether ``torchrun`` (or a launcher like it) set this process's
    rank and world size."""
    return _env_int("RANK") is not None and _env_int("WORLD_SIZE") is not None


def make_mesh(world_size: Optional[int] = None, *, device="cuda",
              backend: Optional[str] = None, rank: Optional[int] = None,
              local_rank: Optional[int] = None,
              local_world_size: Optional[int] = None,
              init_method: Optional[str] = None) -> Mesh:
    """This process's :class:`Mesh`, joining a process group or starting
    one. An initialized group is used as it is; under ``torchrun`` the
    group is joined through the environment; otherwise ``init_method``
    (a ``file://`` store) with ``rank``, or, for a ``world_size`` of 1, a
    store of its own. ``world_size``, when given, must equal the group's.
    ``device`` "cuda" puts the rank on ``cuda:(local_rank %
    device_count)``; "cpu" keeps it on the CPU. ``backend``: see
    :func:`choose_backend`."""
    dev = resolve_device(device)
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        local_rank = _env_int("LOCAL_RANK") if local_rank is None \
            else local_rank
        local_rank = rank if local_rank is None else local_rank
        chosen = dist.get_backend()
    else:
        if under_torchrun():
            rank, size = _env_int("RANK"), _env_int("WORLD_SIZE")
            local_rank = _env_int("LOCAL_RANK") or 0
            local_world_size = _env_int("LOCAL_WORLD_SIZE") or size
            init_method = "env://"
        else:
            size = 1 if world_size is None else int(world_size)
            if rank is None:
                if size != 1:
                    raise ValueError(
                        f"a group of {size} ranks needs each rank's number "
                        "and a store (spawn() starts such ranks), or "
                        "torchrun")
                rank = 0
            local_rank = rank if local_rank is None else local_rank
            local_world_size = size if local_world_size is None \
                else local_world_size
        _check_size(size, world_size)
        count = torch.cuda.device_count() if dev.type == "cuda" else 0
        chosen = choose_backend(dev.type, local_world_size or size, count,
                                backend)
        dev = _rank_device(dev, local_rank)
        if init_method is None:
            # the store lives as long as the group (close_mesh removes it)
            _OWN_STORES.append(tempfile.mkdtemp(prefix="fvsrn_dist_"))
            init_method = "file://" + os.path.join(_OWN_STORES[-1], "store")
        dist.init_process_group(
            chosen, init_method=init_method, world_size=size, rank=rank,
            timeout=TIMEOUT, device_id=dev if chosen == "nccl" else None)
    _check_size(size, world_size)
    return Mesh(rank, size, local_rank, _rank_device(dev, local_rank),
                chosen)


def _check_size(size: int, world_size: Optional[int]) -> None:
    if world_size is not None and int(world_size) != size:
        raise ValueError(f"the process group has {size} ranks, not "
                         f"{world_size}")


def _rank_device(dev: torch.device, local_rank: int) -> torch.device:
    """``cuda:(local_rank % device_count)``, made current, or the CPU."""
    if dev.type != "cuda":
        return dev
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def close_mesh() -> None:
    """Leave the process group (every rank calls it) and remove the store
    :func:`make_mesh` made for it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    while _OWN_STORES:
        shutil.rmtree(_OWN_STORES.pop(), ignore_errors=True)


def _rank_main(rank, fn, world_size, init_method, device, backend,
               result_dir, args):
    mesh = make_mesh(world_size, device=device, backend=backend, rank=rank,
                     local_rank=rank, local_world_size=world_size,
                     init_method=init_method)
    try:
        out = fn(mesh, *args)
        if mesh.is_main:
            torch.save(out, os.path.join(result_dir, RESULT_FILE))
        dist.barrier()
    finally:
        close_mesh()


def spawn(fn: Callable, world_size: int, *args, device="cuda",
          backend: Optional[str] = None):
    """Run ``fn(mesh, *args)`` on ``world_size`` new processes on this
    host, rank r with local rank r, joined through a ``file://`` store in
    a temporary directory; returns what rank 0's ``fn`` returned (through
    ``torch.save``: tensors, arrays, numbers, containers of them).
    ``fn`` must be importable by name (a module-level function). A rank
    that raises or dies stops the others, and the error is raised here
    (``torch.multiprocessing.ProcessRaisedException`` or
    ``ProcessExitedException``)."""
    resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="fvsrn_spawn_")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, nprocs=world_size, join=True, start_method="spawn",
            args=(fn, world_size, "file://" + os.path.join(tmp, "store"),
                  str(device), backend, tmp, args))
        return torch.load(os.path.join(tmp, RESULT_FILE),
                          map_location="cpu", weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _map(fn: Callable[[Tensor], Any], tree):
    """``fn`` over the tensors and arrays of ``tree`` (a tensor, an
    array, or tuples, lists, named tuples and dicts of them); other leaves
    pass unchanged."""
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def shard_batch(mesh: Mesh, batch):
    """The rank's slice of the leading axis of every tensor in ``batch``
    (N divisible by the world size), on the rank's device: rank r takes
    rows [r N / n, (r + 1) N / n)."""
    def shard(t: Tensor) -> Tensor:
        n = t.shape[0]
        if n % mesh.world_size:
            raise ValueError(f"leading axis {n} is not divisible by the "
                             f"world size {mesh.world_size}")
        k = n // mesh.world_size
        return t[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device)
    return _map(shard, batch)


def gather_batch(mesh: Mesh, tree):
    """Every rank's tensors of ``tree`` (equal shapes on every rank)
    concatenated along the leading axis in rank order, on every rank: the
    inverse of :func:`shard_batch`."""
    def gather(t: Tensor) -> Tensor:
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
        dist.all_gather(parts, t)
        return torch.cat(parts, dim=0)
    return _map(gather, tree)


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's ``module`` on every rank: moved to the rank's device, its
    parameters and buffers overwritten in place by rank 0's."""
    module.to(mesh.device)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def all_mean(mesh: Mesh, value: Tensor) -> Tensor:
    """The mean of ``value`` over the ranks (JAX's ``pmean``): the sum,
    divided by the world size."""
    value = value.detach().clone()
    dist.all_reduce(value)
    return value / mesh.world_size
