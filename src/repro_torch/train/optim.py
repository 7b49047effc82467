"""Optimizers: AdamW and Adafactor, with state-dtype policies, ported from
``src/repro/train/optim.py``.

The math is the reference's, in f32: the warmup-cosine schedule, the clip
from the global gradient norm, bias correction at ``count``, weight decay
only on tensors of two or more dimensions, and ``state_dtype`` for m/v.
Trees are the port's parameter trees (nested dicts and lists of tensors);
the step ``count`` is a 0-d int32 tensor beside them, on their device,
so a step reads nothing back to the host.

The rules read a tensor's dimensions, and the reference stacks the
layers of a period along a leading axis where the port keeps a list of
layers.  So the updates take ``stacks``: groups of leaf positions (in
``leaves`` order) that the reference holds as one stacked tensor.  A
leaf in a group counts one dimension more: a layer's norm scale is
(layers, d) there, so it takes weight decay, and Adafactor factors its
second moment into a row per layer and a column shared by the group.
With no ``stacks`` every leaf stands for itself.

Where the reference returns new trees, the updates here write the
parameters and the optimizer state **in place** (a full-width state is
three copies of the parameters; a functional update would hold a fourth)
and return the same trees.  Everything runs under ``torch.no_grad``.
This is plain PyTorch: the reference has no kernel here either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"             # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"    # m/v dtype
    warmup: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``) in ``leaves`` order, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, f32; ``step`` an int or a tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup)
                       / max(cfg.decay_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _ref_ndims(params, stacks: Sequence[Sequence[int]] = ()) -> List[int]:
    """Each leaf's number of dimensions in the reference's layout: one
    more for a leaf of ``stacks``."""
    stacked = {i for group in stacks for i in group}
    return [p.ndim + (i in stacked) for i, p in enumerate(leaves(params))]


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(params) -> dict:
    """m and v as f32 zeros shaped like the parameters, and the count."""
    zeros = (lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device))
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": _count(params)}


def cast_state(opt_state, dtype) -> dict:
    """m and v in ``dtype`` (a name or a torch dtype); the count stays."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def cast(x):
        return x if x.ndim == 0 else x.to(dt)

    return {"m": tree_map(cast, opt_state["m"]),
            "v": tree_map(cast, opt_state["v"]),
            "count": opt_state["count"]}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _clip(cfg: OptConfig, gn):
    if cfg.grad_clip <= 0:
        return 1.0
    return torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, m, v, count, stacks=(),
                 grad_norm=None):
    """One AdamW step; writes ``params``, ``m`` and ``v`` in place.
    ``grad_norm`` (default ``global_norm(grads)``) is the norm the clip
    reads: a sharded step passes the norm over every rank's blocks.
    Returns (params, m, v, count + 1, {"grad_norm", "lr"})."""
    count = count + 1
    lr = schedule(cfg, count)
    gn = global_norm(grads) if grad_norm is None else grad_norm
    clip = _clip(cfg, gn)
    cf = count.float()
    c1 = 1 - cfg.b1 ** cf
    c2 = 1 - cfg.b2 ** cf
    for p, g, m_, v_, nd in zip(leaves(params), leaves(grads), leaves(m),
                                leaves(v), _ref_ndims(params, stacks)):
        g = g.float() * clip
        m_new = cfg.b1 * m_.float() + (1 - cfg.b1) * g
        v_new = cfg.b2 * v_.float() + (1 - cfg.b2) * torch.square(g)
        step = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        if cfg.weight_decay > 0 and nd >= 2:
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        m_.copy_(m_new)
        v_.copy_(v_new)
    return params, m, v, count, {"grad_norm": gn, "lr": lr}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment for >= 2-D tensors)
# ---------------------------------------------------------------------------
def _zeros(shape, like) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def adafactor_init(params, stacks=()) -> dict:
    """Per leaf {"row", "col"} for a tensor of 2 or more dimensions in
    the reference's layout, else {"v"}.  A stacked 1-D leaf keeps its
    layer's row (0-d) and a copy of the group's column."""
    nds = iter(_ref_ndims(params, stacks))

    def state_for(p):
        if next(nds) < 2:
            return {"v": _zeros(p.shape, p)}
        if p.ndim < 2:
            return {"row": _zeros((), p), "col": _zeros(p.shape, p)}
        return {"row": _zeros(p.shape[:-1], p),
                "col": _zeros(p.shape[:-2] + p.shape[-1:], p)}

    return {"f": tree_map(state_for, params), "count": _count(params)}


def _states(params, fstate) -> list:
    """The factored state dict of each parameter, in ``leaves`` order."""
    if isinstance(params, dict):
        return [x for k in sorted(params)
                for x in _states(params[k], fstate[k])]
    if isinstance(params, (list, tuple)):
        return [x for p, f in zip(params, fstate) for x in _states(p, f)]
    return [fstate]


def _entry_axes(spec, dim: int, ndim: int) -> tuple:
    """The mesh axes that split dimension ``dim`` (negative) of a block of
    ``ndim`` dimensions under ``spec`` (no spec: none)."""
    from ..distrib.sharding import entry_axes
    at = ndim + dim
    return entry_axes(spec[at]) if spec is not None and at < len(spec) \
        else ()


class _Means:
    """Means over dimensions that mesh axes may split, taken in rounds.
    ``mean(x, dim, axes)`` gives a function returning the mean: at once
    where no axis splits ``dim`` (``x.mean(dim)``, as without a mesh);
    else a partial sum, queued by its axis set, that ``reduce`` sums over
    those axes (one all-reduce of every queued sum of a set, in the
    order the sets were first queued, the same on every rank) and the
    function divides by the whole dimension."""

    def __init__(self, mesh):
        self.mesh, self.queued = mesh, {}

    def mean(self, x, dim: int, axes: tuple):
        if not axes:
            m = x.mean(dim)
            return lambda: m
        part = x.sum(dim)
        self.queued.setdefault(axes, []).append(part)
        n = x.shape[dim] * self.mesh.axis_size(axes)
        return lambda: part / n

    def reduce(self):
        from ..distrib.collectives import all_reduce_
        for axes, parts in self.queued.items():
            flat = torch.cat([q.reshape(-1) for q in parts])
            all_reduce_(flat, self.mesh, axes)
            off = 0
            for q in parts:
                q.copy_(flat[off:off + q.numel()].view_as(q))
                off += q.numel()
        self.queued = {}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, params, grads, fstate, count,
                     stacks=(), grad_norm=None, mesh=None, specs=None):
    """One Adafactor step; writes ``params`` and ``fstate`` in place.
    ``grad_norm`` (default ``global_norm(grads)``) as ``adamw_update``'s.

    On a ``mesh`` (the sharded step), ``params``, ``grads`` and
    ``fstate`` are this rank's blocks and ``specs`` each leaf's spec (in
    ``leaves`` order): a factor's mean over a dimension that mesh axes
    split is a partial sum, summed over those axes.  A row (the mean
    over dim -1) over the axes of the leaf's dim -1, a column (over dim
    -2) and the row's own mean over those of its dim -2; a stacked 1-D
    leaf's row over its one dimension's axes, its column and the row's
    mean (over the group's layers, which no axis splits) at once.  The
    sums go in two rounds, rows and columns then the rows' means, one
    all-reduce a round for each axis set.
    Returns (params, fstate, count + 1, {"grad_norm", "lr"})."""
    count = count + 1
    lr = schedule(cfg, count)
    decay = 1.0 - (count.float() + 1.0) ** -0.8
    gn = global_norm(grads) if grad_norm is None else grad_norm
    clip = _clip(cfg, gn)
    ps, gs, sts = leaves(params), leaves(grads), _states(params, fstate)
    nds = _ref_ndims(params, stacks)
    specs = list(specs) if specs is not None else [None] * len(ps)
    means = _Means(mesh)

    def apply(i, g, vhat):
        # in place on g and vhat, this update's own temporaries: a tied
        # table's further copies (8.4 GB each for command-r-35b's in f32)
        # would set the card's peak
        step = g.div_(vhat.add_(cfg.eps).sqrt_())
        if cfg.weight_decay > 0 and nds[i] >= 2:
            step.add_(ps[i].float(), alpha=cfg.weight_decay)
        ps[i].copy_(ps[i].float().sub_(step.mul_(lr)))

    def grad(ids, stacked):
        """The clipped gradient of a leaf or of a stacked group (its
        leaves along a new dim 0), a tensor of its own."""
        return (torch.stack([gs[i].float() for i in ids]) if stacked
                else gs[ids[0]].float()) * clip

    def square(g):
        return torch.square(g).add_(1e-30)

    # the factored items: a stacked group of 1-D leaves (one (layers, d)
    # tensor in the reference: its column is a mean over the group's
    # layers, so the group updates together) or one leaf of 2 or more
    # dimensions; round 1 queues their rows' and columns' means
    items, grouped = [], set()
    for group in stacks:
        if ps[group[0]].ndim != 1:
            continue
        grouped.update(group)
        g2 = square(grad(group, True))
        axes = _entry_axes(specs[group[0]], -1, 1)
        items.append((list(group), True, means.mean(g2, -1, axes),
                      means.mean(g2, -2, ()), ()))
    for i, p in enumerate(ps):
        if i in grouped or nds[i] < 2:
            continue
        g2 = square(grad([i], False))
        a1, a2 = (_entry_axes(specs[i], d, p.ndim) for d in (-1, -2))
        items.append(([i], False, means.mean(g2, -1, a1),
                      means.mean(g2, -2, a2), a2))
    means.reduce()
    # round 2: the rows' means over their last dimension
    rows = []
    for ids, stacked, row_mean, col_mean, a2 in items:
        st = [sts[i] for i in ids]
        row = torch.stack([s["row"] for s in st]) if stacked \
            else st[0]["row"]
        row = decay * row + (1 - decay) * row_mean()
        col = decay * st[0]["col"] + (1 - decay) * col_mean()
        rows.append((row, col, means.mean(row, -1, a2)))
    means.reduce()
    for (ids, stacked, *_), (row, col, rmean) in zip(items, rows):
        vhat = (row / torch.clamp(rmean().unsqueeze(-1), min=1e-30))[
            ..., None] * col[..., None, :]
        g = grad(ids, stacked)
        if not stacked:
            sts[ids[0]]["row"].copy_(row)
            sts[ids[0]]["col"].copy_(col)
            apply(ids[0], g, vhat)
            continue
        for i, gi, r, vi in zip(ids, g, row, vhat):
            sts[i]["row"].copy_(r)
            sts[i]["col"].copy_(col)
            apply(i, gi, vi)
    for i, (g, st) in enumerate(zip(gs, sts)):
        if i in grouped or nds[i] >= 2:
            continue
        g = g.float() * clip
        vhat = decay * st["v"] + (1 - decay) * square(g)
        st["v"].copy_(vhat)
        apply(i, g, vhat)
    return params, fstate, count, {"grad_norm": gn, "lr": lr}
