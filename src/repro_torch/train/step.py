"""Train state and train step, ported from ``src/repro/train/step.py``:
microbatch gradient accumulation, remat, MoE SPMD wiring and the
optimizer update.

State layout (plain dicts of tensors)::

    {"params": …,
     "opt": {"m": …, "v": …, "count": i32} | {"f": …, "count": i32}}

The reference's step is one pure jitted function; here it runs eagerly:
``loss_and_grads`` takes each microbatch's loss and its gradients with
``torch.autograd.grad`` (the attention, router and SSD kernels'
backwards carry them on the card), and the optimizer writes the
parameters and its state in
place, its rules reading each leaf as the reference lays it out
(``stack_groups``).

**On a mesh** (``make_train_step(..., mesh=)``, AdamW), the state is
stored as ``distrib.tree_shardings`` places it under ``DEFAULT_RULES``:
each rank keeps only its block of every parameter and of m and v, so
its bytes are ``bytes_per_device``'s.  A step takes the global batch and
keeps this rank's rows (split over the data-parallel axes), then runs
``loss_fn`` on the blocks with the model's ``TensorParallel`` layout
(``distrib/tensor_parallel.py``):

1. each layer gathers its leaves as it runs, over the data axes only
   (``GatherFromAxes``; a recurrent block that the model axis does not
   split, over the model axis too), and again in its recompute under
   remat "block": a rank holds one layer's gathered leaves at a time
   beside its blocks and the embedding's, which is gathered once for
   the lookup and the loss;
2. attention (on the rank's heads), the MLPs and the shared experts
   (on the rank's slice of ``mlp``), the SSD blocks (on its heads and
   its slice of ``inner``), the RG-LRU blocks (on its ``lru``
   channels), the embedding and the loss (on its slice of the
   vocabulary) compute in tensor parallel over the model axis where it
   splits them; the MoE layers run expert-parallel (``MoESpmd``); a
   recurrent block that the model axis splits in part is refused;
3. with ``seq_parallel`` (off unless asked for, as in the reference's
   step; ``seq_parallel_for`` is the reference's rule for a wide dense
   model) the residual stream between the sub-layers holds the rank's
   S/n positions: a sub-layer's input is all-gathered over the model
   axis along the sequence and its output reduce-scattered back, the
   norms' weights' gradients are summed over the model axis, and the
   loss sees the whole sequence;
4. each gradient reaches its stored block through its gather's
   backward: a reduce-scatter over the data axes (for gloo with CUDA
   tensors an all-reduce that keeps the block, ``collective_form``),
   then divided by the data ranks: the mean over the token shards;
5. AdamW runs on the blocks, its clip reading the gradient norm over
   every rank's blocks (each block counted once over the ranks that
   hold a copy of it).

Every collective runs in the forward or in an autograd node's backward,
so every rank issues them in the same order.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..configs.base import ModelConfig, ParallelConfig
from ..distrib.collectives import all_reduce
from ..distrib.sharding import entry_axes, local_block, tree_specs
from ..distrib.tensor_parallel import TensorParallel
from ..launch.mesh import dp_axes
from ..models import Model
from ..models.moe import MoESpmd
from . import optim
from .optim import leaves, tree_map


def make_moe_spmd(cfg: ModelConfig, par: ParallelConfig, mesh
                  ) -> Optional[MoESpmd]:
    """The MoE layers' view of ``mesh``: tokens over the pod and data
    axes, experts along the tensor axis; None without a mesh or for a
    dense model.  Where the tensor axis has one rank, every rank holds
    all experts (``expert_axis=None``) and the aux sums are still taken
    over the token axes, so the aux losses are the global batch's."""
    if mesh is None or not cfg.moe.num_experts:
        return None
    token_axes = tuple(a for a in (par.pod_axis, par.fsdp_axis)
                       if a and a in mesh.shape)
    ex = par.tensor_axis if mesh.shape.get(par.tensor_axis, 1) > 1 \
        else None
    return MoESpmd(mesh=mesh, token_axes=token_axes, expert_axis=ex)


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


def init_state_axes(model: Model, opt_cfg: optim.OptConfig):
    """(state of meta tensors, axes tree) of an AdamW state: m and v
    mirror the parameters' axes, the count has none; nothing allocated."""
    if opt_cfg.name != "adamw":
        raise ValueError(f"init_state_axes: the sharded state is ported "
                         f"for AdamW, not {opt_cfg.name!r}")
    params = model.init(device="meta")
    opt = optim.adamw_init(params)
    if opt_cfg.state_dtype != "float32":
        opt = optim.cast_state(opt, opt_cfg.state_dtype)
    axes = model.param_axes()
    return ({"params": params, "opt": opt},
            {"params": axes, "opt": {"m": axes, "v": axes, "count": ()}})


def init_state(model: Model, opt_cfg: optim.OptConfig, seed: int = 0, *,
               device="cuda", mesh=None) -> dict:
    """Seeded parameters on ``device`` and zeroed optimizer state.  With a
    ``mesh``, every rank draws the same seeded parameters and keeps its
    block of each (``tree_specs`` under ``DEFAULT_RULES``), one layer at a
    time, so that a rank never holds more than one whole layer (or the
    embedding) beside its blocks; m and v are zeros of the blocks' shapes
    (AdamW only)."""
    if mesh is None:
        params = model.init(seed, device=device)
    else:
        if opt_cfg.name != "adamw":
            raise ValueError(f"init_state: the sharded state is ported "
                             f"for AdamW, not {opt_cfg.name!r}")
        specs = tree_specs(model.init(device="meta"), model.param_axes(),
                           mesh)

        def keep(path, part):
            spec = specs
            for key in path:
                spec = spec[key]
            return _blocks(part, spec, mesh)
        params = model.init(seed, device=device, keep=keep)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    if opt_cfg.name == "adafactor":
        opt = optim.adafactor_init(params, stack_groups(model, params))
    else:
        opt = optim.adamw_init(params)
        if opt_cfg.state_dtype != "float32":
            opt = optim.cast_state(opt, opt_cfg.state_dtype)
    return {"params": params, "opt": opt}


def _blocks(tree, specs, mesh):
    """This rank's block of every leaf of ``tree``, each whole leaf taken
    out of ``tree`` as its block is made."""
    if isinstance(tree, dict):
        return {k: _blocks(tree.pop(k), specs[k], mesh) for k in list(tree)}
    if isinstance(tree, list):
        out = []
        for i in range(len(tree)):
            leaf, tree[i] = tree[i], None
            out.append(_blocks(leaf, specs[i], mesh))
        return out
    return local_block(tree, specs, mesh)


def loss_and_grads(model: Model, params, batch, *, remat: str, spmd=None):
    """(loss, metrics, grads) of one (micro)batch: the loss and metrics
    detached, the gradients a tree shaped like ``params``.  With
    ``spmd`` (the sharded step's ``TensorParallel``), ``params`` are this
    rank's stored blocks and each gradient is its block's, summed over
    the token shards."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = model.loss_fn(live, batch, remat=remat, spmd=spmd)
    got = iter(torch.autograd.grad(loss, leaves(live)))
    grads = tree_map(lambda _: next(got), live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: Model, opt_cfg: optim.OptConfig,
                    par: ParallelConfig, mesh=None,
                    seq_parallel: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: the state
    is updated in place and returned; ``batch`` holds ``tokens`` and
    ``targets`` (B,S) on the state's device (and ``frontend``
    (B,F,frontend_dim) for a config with a frontend), B divisible by
    ``par.microbatches``.  With a ``mesh`` the state is the sharded one
    of ``init_state(..., mesh=mesh)``, ``batch`` is the global batch (B
    divisible by the data-parallel ranks times the microbatches), and
    the metrics are the global batch's; ``seq_parallel`` splits the
    residual stream over the sequence (S divisible by the model axis;
    see the module docstring)."""
    if mesh is not None:
        return _sharded_step(model, opt_cfg, par, mesh, seq_parallel)
    if seq_parallel:
        raise ValueError("make_train_step: sequence parallelism needs a "
                         "mesh")
    n_micro = max(par.microbatches, 1)

    def train_step(state, batch):
        params = state["params"]
        loss, metrics, grads = _accumulate(model, params, batch, par,
                                           n_micro)
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


def _accumulate(model, params, batch, par, n_micro, spmd=None):
    """(loss, metrics, grads) of ``batch``, split into ``n_micro``
    microbatches whose gradients are averaged."""
    if n_micro == 1:
        return loss_and_grads(model, params, batch, remat=par.remat,
                              spmd=spmd)
    b = batch["tokens"].shape[0] // n_micro
    grads = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    loss = 0.0
    for i in range(n_micro):
        mb = {k: x[i * b:(i + 1) * b] for k, x in batch.items()}
        l_i, metrics, g = loss_and_grads(model, params, mb, remat=par.remat,
                                         spmd=spmd)
        for acc, gi in zip(leaves(grads), leaves(g)):
            acc.add_(gi)
        loss = loss + l_i
    for acc in leaves(grads):
        acc.div_(n_micro)
    return loss / n_micro, metrics, grads


def _sharded_step(model: Model, opt_cfg: optim.OptConfig,
                  par: ParallelConfig, mesh, seq_parallel: bool
                  ) -> Callable:
    """The step on a mesh (see the module docstring)."""
    if opt_cfg.name != "adamw":
        raise ValueError(f"make_train_step: the sharded step runs AdamW, "
                         f"not {opt_cfg.name!r}")
    cfg = model.cfg
    n_micro = max(par.microbatches, 1)
    dp = dp_axes(mesh)
    n_dp = mesh.axis_size(dp)
    tp = TensorParallel(model, mesh, dp, par.tensor_axis,
                        moe=make_moe_spmd(cfg, par, mesh),
                        seq_parallel=seq_parallel)
    ex = tp.moe.expert_axis if tp.moe is not None else None
    flat_specs = leaves_of(tp.specs)
    for spec, names in zip(flat_specs, leaves_of(model.param_axes())):
        if ex is not None and "experts" in names:
            d = names.index("experts")
            if d >= len(spec) or entry_axes(spec[d]) != (ex,):
                raise ValueError(f"make_train_step: experts of a leaf with "
                                 f"spec {spec} are not split over {ex!r}; "
                                 f"build the Model with e_pad a multiple "
                                 f"of {mesh.shape[ex]}")
    every = tuple(mesh.axis_names)
    # each leaf's copies: the ranks that hold the same block
    copies = [mesh.size // math.prod(mesh.shape[a] for e in s
                                     for a in entry_axes(e))
              for s in flat_specs]
    batch_spec = (dp,) if dp else ()

    def train_step(state, batch):
        blocks = state["params"]
        rows = {k: local_block(x, batch_spec, mesh) for k, x in
                batch.items()}
        loss, metrics, grads = _accumulate(model, blocks, rows, par,
                                           n_micro, tp)
        # the gathers' backwards summed each gradient over the token
        # shards: their mean
        grads = tree_map(lambda g: g / n_dp, grads)
        sq = sum(torch.sum(torch.square(g.float())) / c
                 for g, c in zip(leaves(grads), copies))
        gn = torch.sqrt(all_reduce(sq, mesh, every))
        opt = state["opt"]
        _, _, _, count, stats = optim.adamw_update(
            opt_cfg, blocks, grads, opt["m"], opt["v"], opt["count"],
            stack_groups(model, blocks), grad_norm=gn)
        opt["count"] = count
        metrics = dict(metrics)
        for key in ("ce", "z_loss"):
            metrics[key] = _sum(metrics[key]) / n_dp
        metrics["tokens"] = _sum(metrics["tokens"])
        metrics.update(stats)
        metrics["loss"] = _sum(loss) / n_dp
        return state, metrics

    def _sum(x):
        """The sum over the token axes."""
        return all_reduce(x, mesh, dp) if dp else x

    return train_step


def leaves_of(tree) -> list:
    """The leaves of a spec or axes tree (tuples taken whole), in
    ``optim.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_of(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves_of(v)]
    return [tree]

