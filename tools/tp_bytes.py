#!/usr/bin/env python3
"""What the sharded training step moves and holds on one rank, reckoned
from the code (no card, no step run): the collectives a step issues by
kind, their calls and bytes, and the memory a rank holds while it
computes.

    python3 tools/tp_bytes.py [--arch qwen1.5-0.5b] [--mesh 2 2]
                              [--batch 8] [--seq 128] [--remat block]
                              [--seq-parallel] [--reduced] [--layers N]
                              [--opt adamw|adafactor]
                              [--variant flat_dp,param_gather=bfloat16]

For a model of attention, SSD and RG-LRU blocks with dense MLPs (no
frontend or encoder; MoE layers under ``flat_dp`` only, every rank all
experts) on a (data, model) mesh, from ``Model.init(device="meta")``,
``tree_specs`` and ``TensorParallel.split``, it counts what
``make_train_step(..., mesh=)`` issues:

- each leaf's gather over the data axes, one all-gather a dimension
  they split (forward; again in its layer's recompute under remat
  "block"), and the reduce-scatter of its gradient (backward); a leaf
  the data axes do not split is not gathered and its gradient is
  all-reduced;
- each tensor-parallel region of a layer (a sub-layer the model axis
  splits; a parallel block's attention and MLP together): with the
  stream whole, an output sum forward (again in the recompute except
  the layer's last, which the recompute stops before) and an
  input-gradient sum backward; with ``--seq-parallel``, the input's
  all-gather along the sequence forward (again in the recompute) and
  its gradient's reduce-scatter backward, the output's reduce-scatter
  forward (again in the recompute but the layer's last) and its
  gradient's all-gather backward, and the gradient sums of the norms'
  weights on the stream (norm1, norm2, the final norm);
- the gradient sums of whole leaves a split sub-layer reads (qk norms,
  key/value heads the model axis does not divide; an SSD block's
  ``wB``, ``wC``, ``conv_w``, ``conv_b``) and an SSD block's gated norm:
  its sum of squares summed forward (and in the recompute) and its
  gradient summed backward;
- a MoE layer's aux sums over the token axes: the probabilities' and
  the router z's sums forward (again in the recompute) and backward,
  the load's forward;
- the vocabulary-parallel lookup's sum (a reduce-scatter forward and an
  all-gather backward under sequence parallelism), or with the
  vocabulary whole and the stream split the table's gradient sum; the
  hidden states put back together for the loss; the loss's MAX and two
  sums a chunk (forward and recompute) and its input-gradient sum; the
  gradient norm and the four metrics' sums; Adafactor's two rounds of
  factor sums (rows and columns, then the rows' means), one all-reduce
  a round for each set of axes that splits a factored dimension.

The variants (``--variant``, the dry run's): ``param_gather=bfloat16``
halves the gathered and reduce-scattered (or all-reduced) bytes of the
f32 leaves, which travel in 16 bits; ``flat_dp`` makes every axis
data-parallel (groups of all the ranks, no tensor-parallel region);
``microbatches=N`` runs the forward and backward N times on N-th
batches, every gather again; ``gather_once`` changes nothing.

``param_collectives`` sums the bytes of the parameters' gathers and
their gradients' reduces a step (the same in both forms): layer 0's and
all.  A call's bytes are its larger buffer, as ``chip_smoke.py``'s
``CollectiveClock`` counts them: sums and reduce-scatters travel in
f32 (a 16-bit parameter's in 16 bits), the direct form's all-gathers of
activations in the compute dtype.  Both forms are given: ``direct``
(NCCL, gloo with CPU tensors: all-gather and reduce-scatter calls) and
``all_reduce`` (gloo with CUDA tensors: every call an all-reduce, in
f32 but for the 16-bit parameters').  Then the memory: the stored
state (``bytes_per_device``), the gradient blocks, one layer's gathered
leaves, the embedding's, and beside them the whole-tree form (every leaf
and gradient whole).  One ``TP_BYTES {json}`` line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.distrib.sharding import (abstract_mesh,  # noqa: E402
                                          block_shape, bytes_per_device,
                                          entry_axes)
from repro_torch.distrib.tensor_parallel import (  # noqa: E402
    TensorParallel, flat_dp_rules)
from repro_torch.launch.dryrun import parse_variant  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.common import dtype_of  # noqa: E402
from repro_torch.models.moe import padded_experts  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.step import (init_state_axes,  # noqa: E402
                                    leaves_of, stack_groups)

F32 = 4


class Mesh:
    """An abstract (data, model) mesh with the coordinates of rank 0."""

    def __init__(self, shape):
        self.shape = abstract_mesh(tuple(shape), ("data", "model"))
        self.coords = {"data": 0, "model": 0}


def _leaves(tree, spec, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], spec[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, spec[i], path + (i,))
    else:
        yield path, tree, spec


def _gather_calls(shape, spec, mesh, axes, elt):
    """``gather_block``'s calls for a block of ``shape`` over ``axes``:
    [bytes of each all-gather's result] and the gathered shape."""
    shape, out = list(shape), []
    for d, entry in enumerate(spec):
        take = [a for a in entry_axes(entry) if a in axes]
        if take:
            shape[d] *= math.prod(mesh.shape[a] for a in take)
            out.append(math.prod(shape) * elt)
    return out, shape


def _scatter_calls(shape, spec, mesh, axes, elt):
    """``reduce_scatter_block``'s calls for a whole-over-``axes`` tensor of
    ``shape``: [(kind, bytes of its larger buffer)]."""
    shape, out, done = list(shape), [], set()
    for d, entry in enumerate(spec):
        take = [a for a in entry_axes(entry) if a in axes]
        if take:
            out.append(("reduce_scatter", math.prod(shape) * elt))
            shape[d] //= math.prod(mesh.shape[a] for a in take)
            done.update(take)
    if any(a not in done for a in axes):
        out.append(("all_reduce", math.prod(shape) * elt))
    return out


def reckon(arch, mesh_shape, batch, seq, remat, reduced=False,
           seq_parallel=False, n_layers=None, variant="", opt="adamw"):
    over = parse_variant(variant)
    flat = bool(over.get("flat_dp"))
    n_micro = int(over.get("microbatches", 1))
    cast = over.get("param_gather")
    cfg = configs.reduced(arch) if reduced else configs.get(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    if over.get("moe_dispatch") and cfg.moe.num_experts:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch=over["moe_dispatch"]))
    if (cfg.moe.num_experts and not flat) or cfg.frontend != "none" \
            or cfg.n_enc_layers:
        raise SystemExit(f"{arch}: this count covers attention, SSD and "
                         f"RG-LRU blocks with dense MLPs (MoE layers "
                         f"under flat_dp) only")
    mesh = Mesh(mesh_shape)
    model = Model(cfg, e_pad=padded_experts(cfg, mesh.shape["model"])
                  if cfg.moe.num_experts else None)
    rules = flat_dp_rules(mesh.shape) if flat else None
    dp = ("data", "model") if flat else ("data",)
    n_d = math.prod(mesh.shape[a] for a in dp)
    tp = TensorParallel(model, mesh, dp, "model",
                        seq_parallel=seq_parallel and not flat, rules=rules)
    sp = tp.stream is not None
    meta = model.init(device="meta")
    again = 2 if remat == "block" else 1
    calls = {form: {} for form in ("direct", "all_reduce")}

    def add(form, kind, n, nbytes):
        rec = calls[form].setdefault(kind, {"calls": 0, "bytes": 0})
        rec["calls"] += n
        rec["bytes"] += n * nbytes

    def both(kind_direct, n, nbytes, wire=None):
        """``n`` calls of ``nbytes`` in the direct form (an all-gather's
        of activations in the compute dtype); all-reduces of ``wire``
        bytes (f32) in the other."""
        if n:
            add("direct", kind_direct, n, nbytes)
            add("all_reduce", "all_reduce", n, wire or nbytes)

    def nbytes(t):
        return t.numel() * t.element_size()

    def micro(n):
        """``n`` calls a microbatch: the step's count."""
        return n * n_micro

    gathered = {"layer": 0, "embed": 0}
    # the bytes of the parameters' gathers and gradient reduces a step
    # (either form): layer 0's, and all
    param_bytes = {"layer": 0, "total": 0}
    for path, t, spec in _leaves(meta, tp.specs):
        in_layer = path[0] == "layers"
        same = ()
        if tp.model_axis and "rec" in path and \
                tp.split(path[:path.index("rec") + 1]) is None:
            same = (tp.model_axis,)
        block = block_shape(t.shape, spec, mesh.shape)
        elt = 2 if (cast and t.dtype == torch.float32) else t.element_size()
        wire = elt if cast and t.dtype == torch.float32 else F32
        got, whole = _gather_calls(block, spec, mesh, dp + same, elt)
        local = math.prod(whole) * t.element_size()
        if path[0] == "embed":
            gathered["embed"] += local
        elif in_layer and path[1] == 0:
            gathered["layer"] += local
        moved = 0
        for b in got:
            both("all_gather", micro(again if in_layer else 1), b)
            moved += micro(again if in_layer else 1) * b
        if same:        # the backward keeps this rank's block there
            whole = list(_gather_calls(block, spec, mesh, dp, elt)[1])
        for kind, b in _scatter_calls(whole, spec, mesh, dp, wire):
            both(kind, micro(1), b)
            moved += micro(1) * b
        param_bytes["total"] += moved
        if in_layer and path[1] == 0:
            param_bytes["layer"] += moved

    rows = batch // n_d // n_micro
    act = rows * seq * cfg.d_model * F32          # a sum or a scatter
    act_c = rows * seq * cfg.d_model * torch.finfo(
        dtype_of(cfg.compute_dtype)).bits // 8    # an all-gather's

    def region(last):
        """One tensor-parallel region: ``last`` leaves the layer, so the
        recompute stops before its exit."""
        exits = 1 if (last and again == 2) else again
        if sp:
            both("all_gather", micro(again), act_c, act)     # enter
            both("reduce_scatter", micro(1), act)
            both("reduce_scatter", micro(exits), act)        # leave
            both("all_gather", micro(1), act_c, act)
        else:
            both("all_reduce", micro(exits), act)            # g
            both("all_reduce", micro(1), act)                # f

    for i, kind in enumerate(model.kinds):
        p = meta["layers"][i]
        mix = "rec" if "rec" in p else "attn"
        subs = [s for s in (mix, "mlp")
                if s in p and tp.split(("layers", i, s)) is not None]
        if cfg.parallel_block and len(subs) == 2:
            region(last=True)                          # one entry, one exit
        else:
            for j, sub in enumerate(subs):
                region(last=j == len(subs) - 1 and sub == (
                    "mlp" if "mlp" in p else mix))
        if sp:
            for k in ("norm1", "norm2"):
                if k in p:
                    both("all_reduce", micro(1), nbytes(p[k]))
        if "attn" in subs:
            a = p["attn"]
            whole = [k for k in ("q_norm", "k_norm") if k in a]
            if cfg.n_kv_heads % mesh.shape["model"]:
                whole += [k for k in ("wk", "wv", "bk", "bv") if k in a]
            for k in whole:
                both("all_reduce", micro(1), nbytes(a[k]))
        if "rec" in subs and kind == "ssd":
            r = p["rec"]
            for k in ("wB", "wC", "conv_w", "conv_b"):
                both("all_reduce", micro(1), nbytes(r[k]))
            both("all_reduce", micro(again + 1), rows * seq * F32)
        if "moe" in p:
            e_pad = p["moe"]["router"].shape[1]
            # the aux sums: probabilities and z forward (and recompute)
            # and backward, the load forward
            both("all_reduce", micro(again + 1), e_pad * F32)
            both("all_reduce", micro(again + 1), F32)
            both("all_reduce", micro(again), e_pad * F32)

    vocab = tp.split(("embed",)) is not None
    if vocab and sp:
        both("reduce_scatter", micro(1), act)
        both("all_gather", micro(1), act_c, act)
    elif vocab:
        both("all_reduce", micro(1), act)
    elif sp:
        both("all_reduce", micro(1), nbytes(meta["embed"]["embedding"]))
    if sp:
        both("all_reduce", micro(1), nbytes(meta["final_norm"]))
        both("all_gather", micro(1), act_c, act)
    if vocab:
        c = min(512, seq)
        for _ in range(math.ceil(seq / c)):
            both("all_reduce", micro(6), rows * c * F32)
            both("all_reduce", micro(1), rows * c * cfg.d_model * F32)
    both("all_reduce", 1, F32)                  # the gradient norm
    both("all_reduce", 3, F32)                  # ce, z_loss, loss
    both("all_reduce", 1, 8)                    # tokens (int64)
    if opt == "adafactor":
        for rnd in _adafactor_rounds(model, meta, tp.specs, mesh.shape):
            for nb in rnd.values():
                both("all_reduce", 1, nb)

    ocfg = optim.OptConfig(name=opt)
    shapes, axes = init_state_axes(model, ocfg)
    stored = bytes_per_device(shapes, axes, mesh.shape, rules)
    params = sum(nbytes(t) for _, t, _ in _leaves(meta, tp.specs))
    blocks = bytes_per_device(meta, model.param_axes(), mesh.shape, rules)
    return {"arch": arch, "reduced": reduced, "layers": cfg.n_layers,
            "mesh": list(mesh_shape),
            "batch": batch, "seq": seq, "remat": remat,
            "variant": variant, "opt": opt,
            "seq_parallel": sp, "vocab_split": vocab,
            "calls_a_step": calls, "param_collectives": param_bytes,
            "memory": {"stored": stored, "grad_blocks": blocks,
                       "one_layer_gathered": gathered["layer"],
                       "embedding_gathered": gathered["embed"],
                       "whole_tree_params": params,
                       "whole_tree_grads": params}}


def _adafactor_rounds(model, meta, specs, sizes):
    """Adafactor's two rounds on a mesh (``optim.adafactor_update``):
    [{axes: bytes of the partial sums they sum}] for the rows and
    columns, then for the rows' means."""
    flat = optim.leaves(meta)
    spec_of = leaves_of(specs)
    blocks = [block_shape(t.shape, s, sizes) for t, s in zip(flat, spec_of)]
    stacks = stack_groups(model, meta)
    grouped = {i for g in stacks if flat[g[0]].ndim == 1 for i in g}
    one, two = {}, {}

    def axes(spec, dim, ndim):
        at = ndim + dim
        return entry_axes(spec[at]) if at < len(spec) else ()

    def queue(rnd, ax, numel):
        if ax:
            rnd[ax] = rnd.get(ax, 0) + numel * F32
    for g in stacks:
        if flat[g[0]].ndim == 1:        # a row a layer; the rest local
            queue(one, axes(spec_of[g[0]], -1, 1), len(g))
    for i, (t, b) in enumerate(zip(flat, blocks)):
        if i in grouped or t.ndim < 2:
            continue
        a1, a2 = axes(spec_of[i], -1, t.ndim), axes(spec_of[i], -2, t.ndim)
        queue(one, a1, math.prod(b[:-1]))
        queue(one, a2, math.prod(b[:-2] + b[-1:]))
        queue(two, a2, math.prod(b[:-2]))
    return [one, two]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--mesh", type=int, nargs=2, default=(2, 2))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--remat", choices=("block", "none"), default="block")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="the residual stream split over the sequence")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced size (the CPU tests')")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    ap.add_argument("--opt", choices=("adamw", "adafactor"),
                    default="adamw")
    ap.add_argument("--variant", default="",
                    help="the dry run's: flat_dp, param_gather=bfloat16, "
                         "microbatches=N, gather_once, moe_dispatch=...")
    args = ap.parse_args(argv)
    print("TP_BYTES " + json.dumps(reckon(args.arch, args.mesh, args.batch,
                                          args.seq, args.remat,
                                          args.reduced, args.seq_parallel,
                                          args.layers, args.variant,
                                          args.opt)))


if __name__ == "__main__":
    main()
