"""Optimizer factory: Adam (or AdamW, SGD, RMSprop) with a StepLR
schedule.

Counterpart of ``fvsrn_tpu/train/optimizer.py``. The JAX package builds
an optax transformation whose schedule counts update steps; the port
returns a ``(torch.optim.Optimizer, LambdaLR)`` pair whose scheduler the
trainer steps once after every optimizer step, so the learning rate of
update n (counted from 0) is ``step_lr(...)(n)`` in both packages.
Adam and AdamW share optax's update formula and defaults (betas 0.9 and
0.999, eps 1e-8; AdamW's weight decay is set to optax's 1e-4, PyTorch's
default being 1e-2). RMSprop takes optax's decay 0.9 and eps 1e-8, but
PyTorch adds eps outside the square root where optax adds it inside, so
its updates differ slightly.

L-BFGS is ``torch.optim.LBFGS`` with the strong-Wolfe line search, the
counterpart of optax's ``lbfgs`` with its zoom line search. It is another
algorithm, and it steps through a closure (``opt.step(closure)``, the
closure zeroing the gradients, computing the loss, calling
``backward()`` and returning the loss), so the trainers, whose steps call
``opt.step()``, refuse it. Like optax's, it takes no learning-rate
schedule: its scheduler keeps the rate as it is.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

import torch
from torch.optim.lr_scheduler import LambdaLR

# optax's defaults, stated for PyTorch
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def step_lr(lr: float, lr_step: int, lr_gamma: float,
            steps_per_epoch: int = 1) -> Callable[[int], float]:
    """StepLR: lr * gamma^(epoch // lr_step), as a function of the update
    count."""
    def schedule(count: int) -> float:
        epoch = count // steps_per_epoch
        return lr * (lr_gamma ** (epoch // lr_step))
    return schedule


def make_optimizer(params: Iterable[torch.Tensor], optimizer: str = "Adam",
                   lr: float = 0.01, lr_step: int = 500,
                   lr_gamma: float = 0.5, steps_per_epoch: int = 1,
                   **optim_params: Any):
    """(optimizer, scheduler) over ``params`` with the JAX package's
    defaults (Adam, lr=0.01, lr_step=500, lr_gamma=0.5). Step the
    scheduler after every optimizer step. "lbfgs" builds
    ``torch.optim.LBFGS(params, line_search_fn="strong_wolfe",
    **optim_params)`` (``lr`` and the schedule are not read, as optax's
    ``lbfgs`` reads neither), whose ``step`` takes a closure that
    re-evaluates the loss (see the module doc)."""
    schedule = step_lr(lr, lr_step, lr_gamma, steps_per_epoch)
    name = optimizer.lower()
    params = list(params)
    if name == "adam":
        kw = dict(betas=ADAM_BETAS, eps=ADAM_EPS)
        kw.update(optim_params)
        opt = torch.optim.Adam(params, lr=lr, **kw)
    elif name == "adamw":
        kw = dict(betas=ADAM_BETAS, eps=ADAM_EPS,
                  weight_decay=ADAMW_WEIGHT_DECAY)
        kw.update(optim_params)
        opt = torch.optim.AdamW(params, lr=lr, **kw)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, **optim_params)
    elif name == "rmsprop":
        kw = dict(alpha=0.9, eps=1e-8)
        kw.update(optim_params)
        opt = torch.optim.RMSprop(params, lr=lr, **kw)
    elif name == "lbfgs":
        opt = torch.optim.LBFGS(params, line_search_fn="strong_wolfe",
                                **optim_params)
        return opt, LambdaLR(opt, lambda count: 1.0)
    else:
        raise ValueError(f"unknown optimizer {optimizer}")
    scheduler = LambdaLR(opt, lambda count: schedule(count) / lr)
    return opt, scheduler
