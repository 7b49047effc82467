"""Train state and train step, ported from ``src/repro/train/step.py``:
microbatch gradient accumulation, remat and the optimizer update.

State layout (plain dicts of tensors on one device)::

    {"params": …,
     "opt": {"m": …, "v": …, "count": i32} | {"f": …, "count": i32}}

The reference's step is one pure jitted function; here it runs eagerly:
``loss_and_grads`` takes each microbatch's loss and its gradients with
``torch.autograd.grad`` (the attention, router and SSD kernels'
backwards carry them on the card), and the optimizer writes the
parameters and its state in
place, its rules reading each leaf as the reference lays it out
(``stack_groups``).  There is no ``MoESpmd`` (ROADMAP A10): the step runs on one
device.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ParallelConfig
from ..models import Model
from . import optim
from .optim import leaves, tree_map


def stack_groups(model: Model, params) -> list:
    """Positions, in ``optim.leaves`` order, of the leaves that the
    reference holds as one tensor stacked over layers: a group for each
    period position and each leaf of its layers (the optimizer's
    ``stacks``)."""
    pos = iter(range(len(leaves(params))))
    index = tree_map(lambda _: next(pos), params)

    def layer(where, i):
        return (index["layers"][i] if where == "layers"
                else index["encoder"]["layers"][i])
    return [list(group) for layer_ids in model.stacked_layers()
            for group in zip(*(leaves(layer(*at)) for at in layer_ids))]


def init_state(model: Model, opt_cfg: optim.OptConfig, seed: int = 0, *,
               device="cuda") -> dict:
    """Seeded parameters on ``device`` and zeroed optimizer state."""
    params = model.init(seed, device=device)
    if opt_cfg.name == "adafactor":
        opt = optim.adafactor_init(params, stack_groups(model, params))
    else:
        opt = optim.adamw_init(params)
        if opt_cfg.state_dtype != "float32":
            opt = optim.cast_state(opt, opt_cfg.state_dtype)
    return {"params": params, "opt": opt}


def loss_and_grads(model: Model, params, batch, *, remat: str):
    """(loss, metrics, grads) of one (micro)batch: the loss and metrics
    detached, the gradients a tree shaped like ``params``."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = model.loss_fn(live, batch, remat=remat)
    got = iter(torch.autograd.grad(loss, leaves(live)))
    grads = tree_map(lambda _: next(got), live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: Model, opt_cfg: optim.OptConfig,
                    par: ParallelConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: the state
    is updated in place and returned; ``batch`` holds ``tokens`` and
    ``targets`` (B,S) on the state's device (and ``frontend``
    (B,F,frontend_dim) for a config with a frontend), B divisible by
    ``par.microbatches``."""
    n_micro = max(par.microbatches, 1)

    def train_step(state, batch):
        params = state["params"]
        if n_micro == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch,
                                                  remat=par.remat)
        else:
            b = batch["tokens"].shape[0] // n_micro
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = 0.0
            for i in range(n_micro):
                mb = {k: x[i * b:(i + 1) * b] for k, x in batch.items()}
                l_i, metrics, g = loss_and_grads(model, params, mb,
                                                 remat=par.remat)
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi)
                loss = loss + l_i
            for acc in leaves(grads):
                acc.div_(n_micro)
            loss = loss / n_micro

        opt = state["opt"]
        stacks = stack_groups(model, params)
        if opt_cfg.name == "adafactor":
            _, _, count, stats = optim.adafactor_update(
                opt_cfg, params, grads, opt["f"], opt["count"], stacks)
        else:
            _, _, _, count, stats = optim.adamw_update(
                opt_cfg, params, grads, opt["m"], opt["v"], opt["count"],
                stacks)
        opt["count"] = count
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["loss"] = loss
        return state, metrics

    return train_step
