"""Data-parallel training steps and sharded renders over a
:class:`~fvsrn_tpu_torch.parallel.mesh.Mesh`.

Counterpart of ``fvsrn_tpu/parallel/train_step.py``. The contract is the
JAX package's: a data-parallel step makes the same update as the
single-process step on the whole batch. Losses are means and every rank
holds an equal share, so the global gradient is the mean of the ranks'
gradients: each leaf is all-reduced (summed) and divided by the world
size, as JAX's ``pmean``. Every leaf is reduced on its own, in the same
order on every rank, so a reduction does not depend on when it starts.

- :func:`make_dp_world_train_step`, :func:`make_dp_screen_train_step`:
  a step on the rank's shard of the batch, the network and the optimizer
  state replicated (each rank updates its copy with the same averaged
  gradients). ``overlap_grads`` (screen step) starts the latent grid's
  all-reduce as soon as the backward has produced its gradient (a hook
  on the leaf, JAX's ``_pmean_in_bwd``), and the step waits for it before
  the optimizer: bitwise the same update.
- :func:`compose_over`, :func:`make_cp_render`: context-parallel
  marching, each rank a span of the step axis for every ray, the spans
  composited front to back.
- :func:`make_dp_render`: a ray renderer sharded over the ranks, the
  rays gathered back in order on every rank.

The kernels these paths launch are those of the single-process paths:
rows 2-3 (or 5-6) in the screen step's fused march, row 4 or row 1 in a
sharded render of ``fused_trace_dvr`` or ``mega_trace_dvr``, row 7 in a
sharded ``trace_mc(use_fused=True)``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..raytracer.dvr import RayEvaluationOutput, trace_dvr
from ..train.world import evaluate_world
from .mesh import Mesh, all_mean, gather_batch, shard_batch


def _reduce_grads(mesh: Mesh, params, skip=()) -> None:
    """Each parameter's gradient summed over the ranks and divided by the
    world size, in place, one all-reduce a leaf, in the parameters'
    order; the leaves in ``skip`` are left alone."""
    skip_ids = {id(p) for p in skip}
    for p in params:
        if p.grad is None or id(p) in skip_ids:
            continue
        dist.all_reduce(p.grad)
        p.grad.div_(mesh.world_size)


def make_dp_world_train_step(mesh: Mesh, loss, optimizer):
    """Data-parallel world-space step: ``step(network, batch) -> total``
    on this rank's ``WorldDataset`` shard (``mesh.shard_batch``),
    ``optimizer`` the rank's (optimizer, scheduler) pair over the
    network's parameters; the network is updated in place with the
    gradients averaged over the ranks, and ``total`` is the loss averaged
    over the ranks."""
    opt, scheduler = optimizer

    def step(network, batch):
        opt.zero_grad(set_to_none=True)
        total, _ = evaluate_world(network, batch, loss)
        total.backward()
        _reduce_grads(mesh, network.parameters())
        opt.step()
        scheduler.step()
        return all_mean(mesh, total)

    return step


def make_dp_screen_train_step(mesh: Mesh, tf, config, loss, optimizer, *,
                              width: int, height: int, max_steps: int,
                              use_fused: bool = False,
                              fused_kwargs: Optional[dict] = None,
                              overlap_grads: bool = False):
    """Data-parallel screen-space step (BASELINE config 4): ``step(network,
    ray_start, ray_dir, targets) -> total`` on this rank's cameras
    (C / n, H*W, ...); each rank renders and differentiates whole images,
    so windowed losses (DSSIM) keep their single-process meaning. The
    render is ``train.screen.evaluate_screen`` (``use_fused`` and
    ``fused_kwargs`` as there). ``overlap_grads``: the latent grid's
    gradient (the largest leaf: the flagship's 16 x 32^3 grid outweighs
    its MLP ~40x) is all-reduced from a post-accumulate hook on its leaf,
    asynchronously, while the backward goes on; the step waits for it,
    then reduces the other leaves. The result is bitwise that of
    ``overlap_grads=False``: the same reduction of the same tensor,
    started earlier."""
    from ..train.screen import evaluate_screen

    opt, scheduler = optimizer

    def step(network, rs, rd, targets):
        opt.zero_grad(set_to_none=True)
        grid = network.latent.static_grid if overlap_grads else None
        pending, hook = [], None
        if grid is not None and grid.requires_grad:
            hook = grid.register_post_accumulate_grad_hook(
                lambda p: pending.append(dist.all_reduce(p.grad,
                                                         async_op=True)))
        try:
            total, _ = evaluate_screen(
                network, rs, rd, targets, tf, config, loss, max_steps,
                width, height, use_fused=use_fused,
                fused_kwargs=fused_kwargs)
            total.backward()
        finally:
            if hook is not None:
                hook.remove()
        for work in pending:
            work.wait()
        if pending:
            grid.grad.div_(mesh.world_size)
        _reduce_grads(mesh, network.parameters(),
                      skip=(grid,) if pending else ())
        opt.step()
        scheduler.step()
        return all_mean(mesh, total)

    return step


def compose_over(front: RayEvaluationOutput,
                 back: RayEvaluationOutput) -> RayEvaluationOutput:
    """The associative "over" of two premultiplied partial marches (rgb,
    alpha, alpha-weighted normal and depth, as ``trace_dvr`` returns):
    every premultiplied channel out = front + (1 - a_front) * back, alpha
    a_f + (1 - a_f) a_b. A missing normal stays missing."""
    a_f = front.color[..., 3:4]
    t_f = 1.0 - a_f
    color = torch.cat([front.color[..., :3] + t_f * back.color[..., :3],
                       a_f + t_f * back.color[..., 3:4]], dim=-1)
    normal = None
    if front.normal is not None:
        normal = front.normal + t_f * back.normal
    return RayEvaluationOutput(color=color, depth=front.depth
                               + t_f * back.depth, normal=normal)


def make_cp_render(mesh: Mesh, volume, tf, config, max_steps: int,
                   checkpoint_chunk: Optional[int] = None) -> Callable:
    """Context-parallel (ray-segment) rendering: rank r marches steps
    [r S, (r + 1) S) of every ray, S = ceil(max_steps / n), and the spans'
    partials, gathered on every rank, composite front to back by
    :func:`compose_over`; the same as the single-process march (the over
    operator is associative). Needs ``enable_early_out=False`` (a span
    cannot see the saturation in front of it; ``ValueError`` otherwise)
    and a TF that reads no previous density (preintegration: the carry
    does not cross spans). Returns ``render(ray_start, ray_dir) ->
    RayEvaluationOutput``, the rays and the result the same on every
    rank."""
    if config.enable_early_out:
        raise ValueError("context-parallel marching requires "
                         "enable_early_out=False (a span cannot see "
                         "upstream saturation)")
    n = mesh.world_size
    span = -(-max_steps // n)

    def render(ray_start, ray_dir):
        with torch.no_grad():
            out = trace_dvr(ray_start.to(mesh.device), ray_dir.to(mesh.device),
                            volume, tf, config, span,
                            step_offset=mesh.rank * span,
                            checkpoint_chunk=checkpoint_chunk)
        fields = [f for f in out._fields if getattr(out, f) is not None]
        parts = gather_batch(mesh, [getattr(out, f)[None] for f in fields])
        spans = [RayEvaluationOutput(**{f: p[i] for f, p in
                                        zip(fields, parts)})
                 for i in range(n)]
        comp = spans[0]
        for part in spans[1:]:
            comp = compose_over(comp, part)
        return comp

    return render


def make_dp_render(mesh: Mesh, render_rays: Callable) -> Callable:
    """Shard a ray renderer over the ranks: ``render(ray_start, ray_dir,
    *args)`` hands each rank its slice of the rays (the ray count
    divisible by the world size), calls ``render_rays(rs, rd, *args)``
    there, the other arguments as they are, and gathers every rank's
    result (a tensor or a tuple of them, rays on the leading axis) back in
    ray order on every rank."""
    def render(ray_start, ray_dir, *args):
        rs, rd = shard_batch(mesh, (ray_start, ray_dir))
        return gather_batch(mesh, render_rays(rs, rd, *args))

    return render
