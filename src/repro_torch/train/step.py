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

**On a mesh** (``make_train_step(..., mesh=)``), the state is stored as
``distrib.tree_shardings`` places it under ``DEFAULT_RULES`` (and the
caller's ``rules``): each rank keeps only its block of every parameter
and of m and v (AdamW) or of Adafactor's rows, columns and v, so its
bytes are ``bytes_per_device``'s (Adafactor: see
``adafactor_column_copies``).  A step takes the global batch, splits it
into its microbatches (microbatch i the global rows [i·B/n, (i+1)·B/n),
as the reference's) and keeps this rank's rows of each (split over the
data-parallel axes, the axes the rules' ``batch`` entry names), then
runs ``loss_fn`` on the blocks with the model's ``TensorParallel``
layout (``distrib/tensor_parallel.py``):

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
5. the optimizer runs on the blocks, its clip reading the gradient norm
   over every rank's blocks (each block counted once over the ranks that
   hold a copy of it); Adafactor sums its factors' partial means over
   the axes that split them (``optim.adafactor_update``).

``par.param_gather_dtype`` (the dry run's ``param_gather``; a mesh only)
casts each f32 block to that dtype before its gather, so the gathers
and the gradients' reduce-scatters move 16-bit values.  ``rules`` that
split nothing over the model axis and spread ``batch`` and ``embed``
over every axis (the dry run's ``flat_dp``) make every axis
data-parallel: no sub-layer is split, every leaf is gathered over all
axes, the MoE layers hold every expert on every rank with their tokens
over all axes, and sequence parallelism is off.

Every collective runs in the forward or in an autograd node's backward,
so every rank issues them in the same order.

Each step is a ``train.step`` region for ``torch.profiler``
(``telemetry.trace.region``: host-only, nothing synchronised), holding a
``train.forward`` and a ``train.backward`` a microbatch and one
``train.optimizer`` (the clip's norm, on a mesh its all-reduce, and the
update).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..configs.base import ModelConfig, ParallelConfig
from ..distrib.collectives import all_reduce
from ..distrib.sharding import (DEFAULT_RULES, entry_axes, local_block,
                                merge_rules, mesh_shape, tree_specs)
from ..distrib.tensor_parallel import TensorParallel
from ..models import Model
from ..models.common import dtype_of
from ..models.moe import MoESpmd
from ..telemetry import trace
from . import optim
from .optim import leaves, tree_map


def make_moe_spmd(cfg: ModelConfig, par: ParallelConfig, mesh,
                  token_axes=None, data_axes=None) -> Optional[MoESpmd]:
    """The MoE layers' view of ``mesh``: tokens over ``token_axes``
    (default the pod and data axes), experts along the tensor axis; None
    without a mesh or for a dense model.  Where the tensor axis has one
    rank or is data-parallel (among ``data_axes``, default the token
    axes: flat data parallelism), every rank holds all experts
    (``expert_axis=None``) and the aux sums are still taken over the
    token axes, so the aux losses are the global batch's."""
    if mesh is None or not cfg.moe.num_experts:
        return None
    if token_axes is None:
        token_axes = tuple(a for a in (par.pod_axis, par.fsdp_axis)
                           if a and a in mesh.shape)
    token_axes = tuple(token_axes)
    data_axes = token_axes if data_axes is None else tuple(data_axes)
    ex = par.tensor_axis if (mesh.shape.get(par.tensor_axis, 1) > 1 and
                             par.tensor_axis not in data_axes) else None
    return MoESpmd(mesh=mesh, token_axes=token_axes, expert_axis=ex)


def data_axes_of(mesh, rules=None) -> tuple:
    """The data-parallel axes of a step on ``mesh`` under ``rules``: the
    mesh axes that the rules' ``batch`` entry names (``DEFAULT_RULES``:
    the pod and data axes; flat data parallelism: every axis)."""
    return tuple(a for a in merge_rules(DEFAULT_RULES, rules)["batch"]
                 if a in mesh.shape)


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
    """(state of meta tensors, axes tree); nothing allocated.  AdamW: m
    and v mirror the parameters' axes.  Adafactor, as the reference's
    ``adafactor_init`` lays them out: a row has its leaf's axes but the
    last, a column its axes but the one before last, v (a 1-D leaf) its
    axes; a stacked 1-D leaf's row (0-d here, one entry of the
    reference's (layers,) row) has none and its column (a copy of the
    group's, ``adafactor_column_copies``) the leaf's.  The count has
    none."""
    params = model.init(device="meta")
    axes = model.param_axes()
    if opt_cfg.name == "adafactor":
        opt = optim.adafactor_init(params, stack_groups(model, params))
        return ({"params": params, "opt": opt},
                {"params": axes, "opt": {
                    "f": _factor_axes(params, opt["f"], axes),
                    "count": ()}})
    opt = optim.adamw_init(params)
    if opt_cfg.state_dtype != "float32":
        opt = optim.cast_state(opt, opt_cfg.state_dtype)
    return ({"params": params, "opt": opt},
            {"params": axes, "opt": {"m": axes, "v": axes, "count": ()}})


def _factor_axes(params, fstate, axes):
    """The axes of each leaf's factored state (``init_state_axes``)."""
    if isinstance(params, dict):
        return {k: _factor_axes(params[k], fstate[k], axes[k])
                for k in params}
    if isinstance(params, (list, tuple)):
        return type(params)(_factor_axes(p, f, a)
                            for p, f, a in zip(params, fstate, axes))
    a = tuple(axes)
    if "v" in fstate:
        return {"v": a}
    if fstate["row"].ndim == 0:
        return {"row": (), "col": a}
    return {"row": a[:-1], "col": a[:-2] + a[-1:]}


def adafactor_column_copies(model: Model, mesh, rules=None) -> int:
    """The bytes a rank stores beyond the reference's Adafactor state: the
    reference stacks a group's 1-D leaves (the norm scales) as one
    (layers, d) tensor with one column (d,); the port keeps a copy of
    it beside each layer's leaf, so a group of L layers stores L - 1
    columns more.  ``bytes_per_device`` of ``init_state_axes``'s
    Adafactor state less this is the reference's."""
    params = model.init(device="meta")
    specs = leaves_of(tree_specs(params, model.param_axes(), mesh, rules))
    flat = optim.leaves(params)
    sizes = mesh_shape(mesh)
    extra = 0
    for group in stack_groups(model, params):
        p = flat[group[0]]
        if p.ndim != 1:
            continue
        div = math.prod(sizes[a] for e in specs[group[0]]
                        for a in entry_axes(e))
        extra += (len(group) - 1) * p.numel() * 4 // div
    return extra


def init_state(model: Model, opt_cfg: optim.OptConfig, seed: int = 0, *,
               device="cuda", mesh=None, rules=None) -> dict:
    """Seeded parameters on ``device`` and zeroed optimizer state.  With a
    ``mesh``, every rank draws the same seeded parameters and keeps its
    block of each (``tree_specs`` under ``DEFAULT_RULES`` and ``rules``),
    one layer at a time, so that a rank never holds more than one whole
    layer (or the embedding) beside its blocks; the optimizer's state is
    zeros of the blocks' shapes (AdamW's m and v; Adafactor's rows,
    columns and v, the blocks of ``init_state_axes``' layout)."""
    if mesh is None:
        params = model.init(seed, device=device)
    else:
        specs = tree_specs(model.init(device="meta"), model.param_axes(),
                           mesh, rules)

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
    with trace.region("train.forward"):
        loss, metrics = model.loss_fn(live, batch, remat=remat, spmd=spmd)
    with trace.region("train.backward"):
        got = iter(torch.autograd.grad(loss, leaves(live)))
    grads = tree_map(lambda _: next(got), live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model: Model, opt_cfg: optim.OptConfig,
                    par: ParallelConfig, mesh=None,
                    seq_parallel: bool = False, rules=None,
                    batch_axes=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: the state
    is updated in place and returned; ``batch`` holds ``tokens`` and
    ``targets`` (B,S) on the state's device (and ``frontend``
    (B,F,frontend_dim) for a config with a frontend), B divisible by
    ``par.microbatches``.  With a ``mesh`` the state is the sharded one
    of ``init_state(..., mesh=mesh, rules=rules)``, ``batch`` is the
    global batch (B divisible by the data-parallel ranks times the
    microbatches), and the metrics are the global batch's;
    ``seq_parallel`` splits the residual stream over the sequence (S
    divisible by the model axis); ``rules`` override ``DEFAULT_RULES``
    (see the module docstring); ``batch_axes``, the axes that split the
    batch, default the data-parallel ones (a batch that does not divide
    them all is split over fewer, as the reference's activations are,
    and is the same on the ranks of the others)."""
    if mesh is not None:
        return _sharded_step(model, opt_cfg, par, mesh, seq_parallel, rules,
                             batch_axes)
    if seq_parallel:
        raise ValueError("make_train_step: sequence parallelism needs a "
                         "mesh")
    if rules:
        raise ValueError("make_train_step: rules need a mesh")
    n_micro = max(par.microbatches, 1)

    def train_step(state, batch):
        with trace.region("train.step"):
            params = state["params"]
            loss, metrics, grads = _accumulate(model, params, batch, par,
                                               n_micro)
            opt = state["opt"]
            with trace.region("train.optimizer"):
                stacks = stack_groups(model, params)
                if opt_cfg.name == "adafactor":
                    _, _, count, stats = optim.adafactor_update(
                        opt_cfg, params, grads, opt["f"], opt["count"],
                        stacks)
                else:
                    _, _, _, count, stats = optim.adamw_update(
                        opt_cfg, params, grads, opt["m"], opt["v"],
                        opt["count"], stacks)
            opt["count"] = count
            metrics = dict(metrics)
            metrics.update(stats)
            metrics["loss"] = loss
            return state, metrics

    return train_step


def _accumulate(model, params, batch, par, n_micro, spmd=None):
    """(loss, metrics, grads) of ``batch``, split into ``n_micro``
    microbatches whose gradients are averaged (the metrics the last
    microbatch's)."""
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
                  par: ParallelConfig, mesh, seq_parallel: bool, rules,
                  batch_axes) -> Callable:
    """The step on a mesh (see the module docstring)."""
    grads_of = make_sharded_grads(model, par, mesh, seq_parallel, rules,
                                  batch_axes)
    tp = grads_of.layout
    flat_specs = leaves_of(tp.specs)
    every = tuple(mesh.axis_names)
    # each leaf's copies: the ranks that hold the same block
    copies = [mesh.size // math.prod(mesh.shape[a] for e in s
                                     for a in entry_axes(e))
              for s in flat_specs]

    def train_step(state, batch):
        with trace.region("train.step"):
            blocks = state["params"]
            loss, metrics, grads = grads_of(blocks, batch)
            opt = state["opt"]
            with trace.region("train.optimizer"):
                sq = sum(torch.sum(torch.square(g.float())) / c
                         for g, c in zip(leaves(grads), copies))
                gn = torch.sqrt(all_reduce(sq, mesh, every))
                stacks = stack_groups(model, blocks)
                if opt_cfg.name == "adafactor":
                    _, _, count, stats = optim.adafactor_update(
                        opt_cfg, blocks, grads, opt["f"], opt["count"],
                        stacks, grad_norm=gn, mesh=mesh, specs=flat_specs)
                else:
                    _, _, _, count, stats = optim.adamw_update(
                        opt_cfg, blocks, grads, opt["m"], opt["v"],
                        opt["count"], stacks, grad_norm=gn)
            opt["count"] = count
            metrics = dict(metrics)
            metrics.update(stats)
            metrics["loss"] = loss
            return state, metrics

    return train_step


def make_sharded_grads(model: Model, par: ParallelConfig, mesh,
                       seq_parallel: bool = False, rules=None,
                       batch_axes=None) -> Callable:
    """The sharded step's gradients: ``grads_of(blocks, batch) -> (loss,
    metrics, grads)`` over the global ``batch`` (its microbatches taken
    as the reference takes them, each split over ``batch_axes``, default
    the data-parallel axes), the loss and metrics the global batch's
    (the metrics the last microbatch's), each gradient this rank's block
    of the mean over the tokens.  ``grads_of.layout`` is its
    ``TensorParallel``."""
    cfg = model.cfg
    n_micro = max(par.microbatches, 1)
    dp = data_axes_of(mesh, rules)
    tok = dp if batch_axes is None else tuple(batch_axes)
    # the gathers' backwards sum over every data-parallel rank; ranks
    # that hold the same rows (``dp`` beyond ``tok``) add equal terms
    n_dp, n_tok = mesh.axis_size(dp), mesh.axis_size(tok)
    tp = TensorParallel(
        model, mesh, dp, par.tensor_axis,
        moe=make_moe_spmd(cfg, par, mesh, tok, dp),
        seq_parallel=seq_parallel, batch_axes=tok, rules=rules,
        param_dtype=(dtype_of(par.param_gather_dtype)
                     if par.param_gather_dtype else None))
    ex = tp.moe.expert_axis if tp.moe is not None else None
    for spec, names in zip(leaves_of(tp.specs),
                           leaves_of(model.param_axes())):
        if ex is not None and "experts" in names:
            d = names.index("experts")
            if d >= len(spec) or entry_axes(spec[d]) != (ex,):
                raise ValueError(f"make_train_step: experts of a leaf with "
                                 f"spec {spec} are not split over {ex!r}; "
                                 f"build the Model with e_pad a multiple "
                                 f"of {mesh.shape[ex]}")
    batch_spec = (tok,) if tok else ()

    def rows_of(x):
        """This rank's rows of each microbatch of ``x``, in order."""
        if x.shape[0] % (n_micro * n_tok):
            raise ValueError(f"make_train_step: a global batch of "
                             f"{x.shape[0]} does not split into "
                             f"{n_micro} microbatches over {n_tok} ranks")
        rows = [local_block(mb, batch_spec, mesh)
                for mb in (x.chunk(n_micro) if n_micro > 1 else (x,))]
        return rows[0] if n_micro == 1 else torch.cat(rows)

    def _sum(x):
        """The sum over the token axes."""
        return all_reduce(x, mesh, tok) if tok else x

    def grads_of(blocks, batch):
        rows = {k: rows_of(x) for k, x in batch.items()}
        loss, metrics, grads = _accumulate(model, blocks, rows, par,
                                           n_micro, tp)
        # the gathers' backwards summed each gradient over the token
        # shards: their mean
        grads = tree_map(lambda g: g / n_dp, grads)
        metrics = dict(metrics)
        for key in ("ce", "z_loss"):
            metrics[key] = _sum(metrics[key]) / n_tok
        metrics["tokens"] = _sum(metrics["tokens"])
        return _sum(loss) / n_tok, metrics, grads

    grads_of.layout = tp
    return grads_of


def leaves_of(tree) -> list:
    """The leaves of a spec or axes tree (tuples taken whole), in
    ``optim.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_of(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves_of(v)]
    return [tree]

