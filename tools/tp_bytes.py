#!/usr/bin/env python3
"""What the sharded training step moves and holds on one rank, reckoned
from the code (no card, no step run): the collectives a step issues by
kind, their calls and bytes, and the memory a rank holds while it
computes.

    python3 tools/tp_bytes.py [--arch qwen1.5-0.5b] [--mesh 2 2]
                              [--batch 8] [--seq 128] [--remat block]
                              [--seq-parallel] [--reduced] [--layers N]

For a model of attention, SSD and RG-LRU blocks with dense MLPs (no
MoE, frontend or encoder) on a (data, model) mesh, from
``Model.init(device="meta")``, ``tree_specs`` and
``TensorParallel.split``, it counts what ``make_train_step(..., mesh=)``
issues:

- each leaf's gather over the data axis (forward; again in its layer's
  recompute under remat "block") and the reduce-scatter of its gradient
  (backward); a leaf the data axis does not split is not gathered and
  its gradient is all-reduced;
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
- the vocabulary-parallel lookup's sum (a reduce-scatter forward and an
  all-gather backward under sequence parallelism), or with the
  vocabulary whole and the stream split the table's gradient sum; the
  hidden states put back together for the loss; the loss's MAX and two
  sums a chunk (forward and recompute) and its input-gradient sum; the
  gradient norm and the four metrics' sums.

A call's bytes are its larger buffer, as ``chip_smoke.py``'s
``CollectiveClock`` counts them: sums and reduce-scatters travel in
f32, the direct form's all-gathers of activations in the compute dtype.
Both forms are given: ``direct`` (NCCL, gloo with CPU tensors:
all-gather and reduce-scatter calls) and ``all_reduce`` (gloo with CUDA
tensors: every call an all-reduce, in f32).  Then the memory: the stored
state (``bytes_per_device``), the gradient blocks, one layer's gathered
leaves, the embedding's, and beside them the whole-tree form (every leaf
and gradient whole).  One ``TP_BYTES {json}`` line.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.distrib.sharding import (abstract_mesh,  # noqa: E402
                                          bytes_per_device, entry_axes)
from repro_torch.distrib.tensor_parallel import TensorParallel  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.common import dtype_of  # noqa: E402
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


def reckon(arch, mesh_shape, batch, seq, remat, reduced=False,
           seq_parallel=False, n_layers=None):
    cfg = configs.reduced(arch) if reduced else configs.get(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    if cfg.moe.num_experts or cfg.frontend != "none" or cfg.n_enc_layers:
        raise SystemExit(f"{arch}: this count covers attention, SSD and "
                         f"RG-LRU blocks with dense MLPs only")
    model = Model(cfg)
    mesh = Mesh(mesh_shape)
    n_d = mesh.shape["data"]
    tp = TensorParallel(model, mesh, ("data",), "model",
                        seq_parallel=seq_parallel)
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

    gathered = {"layer": 0, "embed": 0}
    for path, t, spec in _leaves(meta, tp.specs):
        split = [a for e in spec for a in entry_axes(e)]
        local = nbytes(t) // math.prod(
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
    act = rows * seq * cfg.d_model * F32          # a sum or a scatter
    act_c = rows * seq * cfg.d_model * torch.finfo(
        dtype_of(cfg.compute_dtype)).bits // 8    # an all-gather's

    def region(last):
        """One tensor-parallel region: ``last`` leaves the layer, so the
        recompute stops before its exit."""
        exits = 1 if (last and again == 2) else again
        if sp:
            both("all_gather", again, act_c, act)     # enter
            both("reduce_scatter", 1, act)
            both("reduce_scatter", exits, act)        # leave
            both("all_gather", 1, act_c, act)
        else:
            both("all_reduce", exits, act)            # g
            both("all_reduce", 1, act)                # f

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
                    both("all_reduce", 1, nbytes(p[k]))
        if "attn" in subs:
            a = p["attn"]
            whole = [k for k in ("q_norm", "k_norm") if k in a]
            if cfg.n_kv_heads % mesh.shape["model"]:
                whole += [k for k in ("wk", "wv", "bk", "bv") if k in a]
            for k in whole:
                both("all_reduce", 1, nbytes(a[k]))
        if "rec" in subs and kind == "ssd":
            r = p["rec"]
            for k in ("wB", "wC", "conv_w", "conv_b"):
                both("all_reduce", 1, nbytes(r[k]))
            both("all_reduce", again + 1, rows * seq * F32)  # the norm

    vocab = tp.split(("embed",)) is not None
    if vocab and sp:
        both("reduce_scatter", 1, act)
        both("all_gather", 1, act_c, act)
    elif vocab:
        both("all_reduce", 1, act)
    elif sp:
        both("all_reduce", 1, nbytes(meta["embed"]["embedding"]))
    if sp:
        both("all_reduce", 1, nbytes(meta["final_norm"]))
        both("all_gather", 1, act_c, act)
    if vocab:
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
    params = sum(nbytes(t) for _, t, _ in _leaves(meta, tp.specs))
    blocks = bytes_per_device(meta, model.param_axes(), mesh.shape)
    return {"arch": arch, "reduced": reduced, "layers": cfg.n_layers,
            "mesh": list(mesh_shape),
            "batch": batch, "seq": seq, "remat": remat,
            "seq_parallel": sp, "vocab_split": vocab,
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
    ap.add_argument("--seq-parallel", action="store_true",
                    help="the residual stream split over the sequence")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced size (the CPU tests')")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers")
    args = ap.parse_args(argv)
    print("TP_BYTES " + json.dumps(reckon(args.arch, args.mesh, args.batch,
                                          args.seq, args.remat,
                                          args.reduced, args.seq_parallel,
                                          args.layers)))


if __name__ == "__main__":
    main()
