#!/usr/bin/env python3
"""What the sharded training step moves and holds on one rank, reckoned
from the code (no card, no step run): the collectives a step issues by
kind, their calls and bytes, and the memory a rank holds while it
computes.

    python3 tools/tp_bytes.py [--arch qwen1.5-0.5b] [--mesh 2 2]
                              [--batch 8] [--seq 128] [--remat block]
                              [--reduced]

For a dense attention model (attention, MLP, no MoE, recurrent block or
frontend) on a (data, model) mesh, from ``Model.init(device="meta")``,
``tree_specs`` and ``TensorParallel.split``, it counts what
``make_train_step(..., mesh=)`` issues:

- each leaf's gather over the data axis (forward; again in its layer's
  recompute under remat "block") and the reduce-scatter of its gradient
  (backward); a leaf the data axis does not split is not gathered and
  its gradient is all-reduced;
- the f/g all-reduces of the tensor-parallel sub-layers (an output sum
  forward, again in the recompute except the layer's last, which the
  recompute stops before; an input-gradient sum backward), the
  gradient sums of whole leaves a split sub-layer reads (qk norms, key/
  value heads the model axis does not divide), the vocabulary-parallel
  lookup's sum and the loss's MAX and two sums a chunk (forward and
  recompute) and its input-gradient sum; the gradient norm and the four
  metrics' sums.

A call's bytes are its larger buffer, as ``chip_smoke.py``'s
``CollectiveClock`` counts them: activations travel in f32.  Both forms
are given: ``direct`` (NCCL, gloo with CPU tensors: all-gather and
reduce-scatter calls) and ``all_reduce`` (gloo with CUDA tensors: every
call an all-reduce).  Then the memory: the stored state
(``bytes_per_device``), the gradient blocks, one layer's gathered
leaves, the embedding's, and beside them today's whole-tree form (every
leaf and gradient whole).  One ``TP_BYTES {json}`` line.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.distrib.sharding import (abstract_mesh,  # noqa: E402
                                          bytes_per_device, entry_axes)
from repro_torch.distrib.tensor_parallel import TensorParallel  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.step import init_state_axes  # noqa: E402

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


def reckon(arch, mesh_shape, batch, seq, remat, reduced=False):
    cfg = configs.reduced(arch) if reduced else configs.get(arch)
    if (cfg.moe.num_experts or cfg.frontend != "none"
            or any(k not in ("attn", "local", "global") for k in cfg.period)):
        raise SystemExit(f"{arch}: this count covers dense attention "
                         f"models only")
    model = Model(cfg)
    mesh = Mesh(mesh_shape)
    n_d, n_m = mesh.shape["data"], mesh.shape["model"]
    tp = TensorParallel(model, mesh, ("data",), "model")
    meta = model.init(device="meta")
    again = 2 if remat == "block" else 1
    calls = {form: {} for form in ("direct", "all_reduce")}

    def add(form, kind, n, nbytes):
        rec = calls[form].setdefault(kind, {"calls": 0, "bytes": 0})
        rec["calls"] += n
        rec["bytes"] += n * nbytes

    def both(kind_direct, n, nbytes):
        add("direct", kind_direct, n, nbytes)
        add("all_reduce", "all_reduce", n, nbytes)

    gathered = {"layer": 0, "embed": 0}
    for path, t, spec in _leaves(meta, tp.specs):
        split = [a for e in spec for a in entry_axes(e)]
        local = t.numel() * t.element_size() // math.prod(
            mesh.shape[a] for a in split if a == "model")
        in_layer = path[0] == "layers"
        if path[0] == "embed":
            gathered["embed"] += local
        elif in_layer and path[1] == 0:
            gathered["layer"] += local
        if "data" in split:
            both("all_gather", again if in_layer else 1, local)
            both("reduce_scatter", 1, local)
        else:
            both("all_reduce", 1, local)

    rows = batch // n_d
    act = rows * seq * cfg.d_model * F32
    vocab = tp.split(("embed",)) is not None
    for i in range(cfg.n_layers):
        subs = [s for s in ("attn", "mlp")
                if tp.split(("layers", i, s)) is not None]
        for j, sub in enumerate(subs):
            last = j == len(subs) - 1
            both("all_reduce", 1 if (last and again == 2) else again, act)
            both("all_reduce", 1, act)
        if "attn" in subs:
            a = meta["layers"][i]["attn"]
            whole = [k for k in ("q_norm", "k_norm") if k in a]
            if cfg.n_kv_heads % n_m:
                whole += [k for k in ("wk", "wv", "bk", "bv") if k in a]
            for k in whole:
                both("all_reduce", 1, a[k].numel() * a[k].element_size())
    if vocab:
        both("all_reduce", 1, act)
        c = min(512, seq)
        for _ in range(math.ceil(seq / c)):
            both("all_reduce", 6, rows * c * F32)
            both("all_reduce", 1, rows * c * cfg.d_model * F32)
    both("all_reduce", 1, F32)                  # the gradient norm
    both("all_reduce", 3, F32)                  # ce, z_loss, loss
    both("all_reduce", 1, 8)                    # tokens (int64)

    ocfg = optim.OptConfig()
    shapes, axes = init_state_axes(model, ocfg)
    stored = bytes_per_device(shapes, axes, mesh.shape)
    params = sum(t.numel() * t.element_size() for _, t, _ in
                 _leaves(meta, tp.specs))
    blocks = bytes_per_device(meta, model.param_axes(), mesh.shape)
    return {"arch": arch, "reduced": reduced, "mesh": list(mesh_shape),
            "batch": batch,
            "seq": seq, "remat": remat, "vocab_split": vocab,
            "calls_a_step": calls,
            "memory": {"stored": stored, "grad_blocks": blocks,
                       "one_layer_gathered": gathered["layer"],
                       "embedding_gathered": gathered["embed"],
                       "whole_tree_params": params,
                       "whole_tree_grads": params}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--mesh", type=int, nargs=2, default=(2, 2))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--remat", choices=("block", "none"), default="block")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced size (the CPU tests')")
    args = ap.parse_args(argv)
    print("TP_BYTES " + json.dumps(reckon(args.arch, args.mesh, args.batch,
                                          args.seq, args.remat,
                                          args.reduced)))


if __name__ == "__main__":
    main()
