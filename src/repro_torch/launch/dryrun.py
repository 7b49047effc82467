"""Dry run: trace every (arch × shape × mesh) cell as rank 0 of a fake
256- or 512-rank world, ported from ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each cell's program for 512 fake TPU
host devices.  Here one process joins a ``torch.distributed`` world of
backend ``"fake"`` as rank 0 (its collectives move nothing), builds the
production mesh over it and runs the port's own code for that rank under
``FakeTensorMode``: every tensor is a shape and a dtype, nothing is
allocated, and the hand-written kernels' wrappers take their shape paths
(``kernels/cost.py``).  Per cell:

* the PRODUCTION trace: the full-depth train step
  (``make_train_step(mesh=, seq_parallel=seq_parallel_for(...))``, remat
  "block"), the sharded prefill (capacity factor 2.0) or the sharded
  decode step (``Model.prefill`` / ``decode_step`` with ``spmd=``), on
  the rank's blocks built from ``tree_specs`` (never drawn).  ``ok``
  means it ran to its end; ``memory.peak_bytes`` is the most live bytes
  of the rank during it (``MemTracker``: the stored blocks, the batch
  and every tensor the step makes), beside the card's 80 GB.
* two COST traces on the single-pod mesh, at 1 and 2 unrolled periods
  (the reference's prefix and trailing layers kept), remat "none": FLOPs
  (``FlopCounterMode``'s matmuls and the kernels' operations from
  ``cost.py``), bytes (inputs and outputs of every aten op that is not a
  view, which is what eager execution moves without fusion, and the
  kernels' bytes from ``cost.py``) and the collectives the port's own
  wrappers record (``collectives.record``: op, result bytes, group),
  each priced by ``wire_bytes``, the reference's ring formulae.  Each is
  linear in depth, so ``a + b·n_periods`` fits the full depth.
* three times for an NVIDIA H100 SXM5 80GB from ``launch.mesh.HW``
  (data-sheet figures, reckoned, not measured): ``t_compute`` = FLOPs /
  989 TFLOP/s, ``t_memory`` = bytes / 3.35 TB/s, ``t_collective`` = Σ
  wire bytes / the ring's link (NVLink's 450 GB/s where its group lies
  within 8 consecutive ranks, a node; else the 50 GB/s NIC).

**Variants** (the reference's hillclimb ``overrides``, ``--variant``: a
comma list of ``k=v`` or bare flags), each recorded with ``variant`` and
``overrides`` in a file of its own (``…__<variant>.json``, ``,`` → ``+``
and ``=`` → ``-``):

* ``moe_dispatch=cumsum``: a MoE config's router dispatches by cumsum;
* ``param_gather=bfloat16`` (train): the step casts each f32 block to
  16 bits before its gather (``ParallelConfig.param_gather_dtype``), so
  the gathers and the gradients' reduce-scatters move 16-bit values;
* ``flat_dp`` (every kind): no tensor parallelism (``flat_dp_rules``):
  every tensor-parallel dim whole, ``embed`` and the batch over every
  axis, the MoE layers' tokens over every axis and all experts on every
  rank, no sequence parallelism;
* ``gather_once`` (train): one gather of a block's post-norm input for
  both branches.  The port's layers already enter each sub-layer's input
  once (a parallel block once for both halves), so the variant traces
  the base cell's collectives;
* ``microbatches=N`` (train): the global batch in N microbatches, each
  split over the data-parallel ranks.

Rank 0 stands for all: every rank runs the same shapes, save where a
rank's share differs (a rank's expert range holds other experts of the
same count; a vocabulary the model axis does not divide, granite's
49,155, is whole on every rank; in decode only the rank whose block
holds the position writes the new K/V).

Records go to ``experiments/dryrun_torch/`` with the reference's keys.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
                                      [--no-cost] [--skip-done]
                                      [--variant flat_dp,microbatches=4]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from .. import configs
from ..configs.base import ModelConfig, ParallelConfig, SHAPES, ShapeSpec
from ..distrib import collectives as coll
from ..distrib.sharding import block_shape, bytes_per_device, tree_specs
from ..distrib.tensor_parallel import (TensorParallel, flat_dp_rules,
                                       seq_parallel_for)
from ..kernels import cost
from ..models import Model
from ..models.moe import MoESpmd, padded_experts
from ..train import optim
from ..train.step import data_axes_of, init_state_axes, make_train_step
from .mesh import HW, dp_axes, make_production_mesh

OUT_DIR = Path("experiments/dryrun_torch")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def wire_bytes(rec: dict) -> float:
    """Per-device wire traffic of one collective (ring algorithms), as
    the reference reckons it."""
    n = max(rec["group"], 1)
    r = rec["result_bytes"]
    if n == 1:
        return 0.0
    if rec["op"] == "all-reduce":
        return 2.0 * r * (n - 1) / n
    if rec["op"] == "all-gather":
        return r * (n - 1) / n            # result is the gathered buffer
    if rec["op"] == "reduce-scatter":
        return r * (n - 1)                 # operand = result * n
    if rec["op"] == "all-to-all":
        return r * (n - 1) / n
    return float(r)


def link_bw(rec: dict) -> float:
    """The bytes/s of one collective's ring: NVLink where its group lies
    within a node of ``HW["node_size"]`` consecutive ranks (rank 0's
    groups start at rank 0), else the NIC."""
    return HW["nvlink_bw"] if rec["span"] <= HW["node_size"] \
        else HW["nic_bw"]


def parse(records) -> dict:
    """A cell's collective records summed: the wire bytes in all and
    their time on the links."""
    return {"wire": sum(wire_bytes(r) for r in records),
            "t": sum(wire_bytes(r) / link_bw(r) for r in records)}


# ===========================================================================
# per-cell builders
# ===========================================================================
def batch_specs(cfg: ModelConfig, shape: ShapeSpec, kind: str) -> dict:
    """The global batch's (shape, dtype) for every model input."""
    B, S = shape.global_batch, shape.seq_len
    F = cfg.frontend_seq if cfg.family == "vlm" else 0
    frontend = {"frontend": ((B, cfg.frontend_seq, cfg.frontend_dim),
                             torch.float32)} \
        if cfg.frontend != "none" else {}
    if kind == "train":
        return {"tokens": ((B, S - F), torch.int32),
                "targets": ((B, S), torch.int32), **frontend}
    if kind == "prefill":
        return {"tokens": ((B, S - F), torch.int32), **frontend}
    return {"tokens": ((B, 1), torch.int32)}


def batch_axes_for(mesh, batch: int, rules=None) -> tuple:
    """The data-parallel axes under ``rules`` (``data_axes_of``) where the
    batch divides them, else none (the reference's ``batch_shardings``).
    Under ``flat_dp``'s rules every axis first; where the batch does not
    divide them, the pod and data axes, as the reference's activations
    are still constrained (``act_sharding_for``)."""
    for dp in (data_axes_of(mesh, rules), dp_axes(mesh)):
        if batch % mesh.axis_size(dp) == 0:
            return dp
    return ()


def cell_rules(shape: ShapeSpec, mesh=None, overrides=None) -> dict:
    """The cell's resolver overrides; under ``flat_dp`` (``mesh``
    given) the flat rules on top, as the reference's ``lower_cell``."""
    rules = {}
    if shape.name == "long_500k":
        # batch=1: spread the KV sequence over (data, model) = 256-way
        rules["kv_seq"] = ("data", "model")
    if (overrides or {}).get("flat_dp"):
        rules.update(flat_dp_rules(mesh))
    return rules


def parse_variant(text: str) -> Dict[str, Any]:
    """The reference's ``--variant``: a comma list of ``k=v`` (a string)
    or a bare flag (True)."""
    overrides: Dict[str, Any] = {}
    for item in text.split(","):
        if not item:
            continue
        if "=" in item:
            k, v = item.split("=", 1)
            overrides[k] = v
        else:
            overrides[item] = True
    return overrides


def variant_name(text: str) -> str:
    """A variant's name in records and file names: ``,`` → ``+``,
    ``=`` → ``-``."""
    return text.replace(",", "+").replace("=", "-")


KNOWN = ("moe_dispatch", "param_gather", "flat_dp", "gather_once",
         "microbatches")


def opt_for(cfg: ModelConfig) -> optim.OptConfig:
    if cfg.name == "nemotron-4-340b":
        return optim.OptConfig(state_dtype="bfloat16")
    return optim.OptConfig()


def par_for(cfg: ModelConfig, mesh, shape: ShapeSpec) -> ParallelConfig:
    return ParallelConfig(
        pod_axis="pod" if "pod" in mesh.shape else None,
        microbatches=1,
        remat="block",
    )


def depth_for(cfg: ModelConfig, unroll_periods: int) -> int:
    """Layers of a cost trace at ``unroll_periods`` periods, the
    reference's prefix (deepseek's dense first layer) and trailing
    layers kept; 0: the config's full depth."""
    if unroll_periods <= 0:
        return cfg.n_layers
    plen = len(cfg.period)
    prefix = 1 if (cfg.moe.first_layer_dense and cfg.moe.num_experts) \
        else 0
    trail = cfg.n_layers % plen if plen > 1 else 0
    return prefix + unroll_periods * plen + trail


def n_periods_of(cfg: ModelConfig) -> int:
    plen = len(cfg.period)
    prefix = 1 if (cfg.moe.first_layer_dense and cfg.moe.num_experts) \
        else 0
    return (cfg.n_layers - prefix) // plen


def model_for(arch: str, mesh, unroll_periods: int = 0,
              cfg: Optional[ModelConfig] = None) -> Model:
    """The cell's model (``cfg``, default the config of ``arch``) at
    ``depth_for``'s layers, a MoE config's experts padded to the model
    axis."""
    cfg = cfg or configs.get(arch)
    cfg = cfg.replace(n_layers=depth_for(cfg, unroll_periods))
    e_pad = padded_experts(cfg, mesh.shape["model"]) \
        if cfg.moe.num_experts else None
    return Model(cfg, e_pad=e_pad)


def _blocks(tree, specs, mesh):
    """Empty tensors of this rank's block shapes (under ``FakeTensorMode``
    they allocate nothing)."""
    if isinstance(tree, dict):
        return {k: _blocks(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_blocks(v, specs[i], mesh)
                          for i, v in enumerate(tree))
    return torch.zeros(block_shape(tree.shape, specs, mesh),
                       dtype=tree.dtype)


def analytic(model: Model, shape: ShapeSpec, mesh, overrides=None
             ) -> Dict[str, int]:
    """The reference's analytic bytes a device: the train state's or the
    parameters', and a decode cell's cache (``bytes_per_device`` under
    the cell's rules and ``overrides``)."""
    rules = cell_rules(shape, mesh, overrides)
    out = {}
    if shape.kind == "train":
        shapes, axes = init_state_axes(model, opt_for(model.cfg))
    else:
        shapes, axes = model.init(device="meta"), model.param_axes()
    out["state_bytes_analytic"] = bytes_per_device(shapes, axes, mesh, rules)
    if shape.kind == "decode":
        shapes, axes = model.cache_axes(shape.global_batch, shape.seq_len)
        out["cache_bytes_analytic"] = bytes_per_device(shapes, axes, mesh,
                                                       rules)
    return out


def lower_cell(arch: str, shape, mesh, *, unroll_periods: int = 0,
               cfg: Optional[ModelConfig] = None,
               cache_len: Optional[int] = None,
               overrides: Optional[dict] = None,
               opt: Optional[optim.OptConfig] = None):
    """Build one cell's inputs and return ``(run, meta, held)``: ``run()``
    runs the cell's step as this rank, ``held`` the tensors the rank
    holds before it starts (its stored blocks, its batch, its cache).
    Under ``FakeTensorMode`` the inputs are fake and ``run`` traces; out
    of it they are zeros and ``run`` is a real step on a real mesh.
    ``shape``: a ``SHAPES`` name or a ``ShapeSpec``; ``cfg`` replaces the
    config of ``arch`` (a reduced one); ``unroll_periods`` > 0: a cost
    trace at that many periods, remat "none"; ``cache_len``: a serving
    cell's cache positions, past its prompt (default the shape's
    ``seq_len``; decode writes the cache's last position);
    ``overrides``: a variant's (``parse_variant``); ``opt``: a train
    cell's optimizer (default ``opt_for``'s)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    overrides = dict(overrides or {})
    unknown = sorted(set(overrides) - set(KNOWN))
    if unknown:
        raise ValueError(f"unknown overrides {unknown}; known: {KNOWN}")
    cfg = cfg or configs.get(arch)
    if overrides.get("moe_dispatch") and cfg.moe.num_experts:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch=overrides["moe_dispatch"]))
    model = model_for(arch, mesh, unroll_periods, cfg)
    cfg = model.cfg
    flat = bool(overrides.get("flat_dp"))
    rules = cell_rules(shape, mesh, overrides)
    meta: Dict[str, Any] = {"arch": arch, "shape": shape.name,
                            "kind": shape.kind, "n_layers": cfg.n_layers}
    B, S = shape.global_batch, shape.seq_len
    bspec = batch_specs(cfg, shape, shape.kind)

    if shape.kind == "train":
        opt = opt or opt_for(cfg)
        shapes, axes = init_state_axes(model, opt)
        state = _blocks(shapes, tree_specs(shapes, axes, mesh, rules), mesh)
        batch = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in bspec.items()}
        par = par_for(cfg, mesh, shape).replace(
            microbatches=int(overrides.get("microbatches", 1)),
            param_gather_dtype=overrides.get("param_gather") or "")
        if unroll_periods:
            par = par.replace(remat="none")
        seq = not flat and seq_parallel_for(cfg, mesh, B, S)
        bax = batch_axes_for(mesh, B, rules)
        meta.update(seq_parallel=seq, batch_axes=list(bax))
        step = make_train_step(model, opt, par, mesh, seq_parallel=seq,
                               rules=rules, batch_axes=bax)

        def run():
            return step(state, batch)
        return run, meta, _tensors(state) + _tensors(batch)

    bax = batch_axes_for(mesh, B, rules)
    moe = None
    if cfg.moe.num_experts:
        moe = MoESpmd(mesh=mesh, token_axes=bax,
                      expert_axis=None if flat else "model")
    tp = TensorParallel(model, mesh, data_axes_of(mesh, rules), "model",
                        moe=moe, batch_axes=bax, rules=rules)
    params = _blocks(model.init(device="meta"), tp.specs, mesh)
    rows = B // mesh.axis_size(bax)
    batch = {k: torch.zeros((rows,) + s[1:], dtype=dt)
             for k, (s, dt) in bspec.items()}
    meta["batch_axes"] = list(bax)
    T = cache_len or S
    if shape.kind == "prefill":
        def run():
            return model.prefill(params, batch["tokens"], cache_len=T,
                                 frontend=batch.get("frontend"), spmd=tp,
                                 capacity_factor=2.0)
        return run, meta, _tensors(params) + _tensors(batch)

    specs, _, _ = model.serve_layout(tp, rows, T)
    shapes, _ = model.cache_axes(B, T)
    cache = {k: torch.zeros(block_shape(t.shape, specs[k], mesh),
                            dtype=t.dtype) for k, t in shapes.items()}

    def run():
        return model.decode_step(params, cache, batch["tokens"], T - 1,
                                 spmd=tp, cache_len=T)
    return run, meta, _tensors(params) + _tensors(cache) + _tensors(batch)


class ByteCount(TorchDispatchMode):
    """The bytes of the inputs and outputs of every aten op that is not a
    view or an uninitialised allocation: what eager execution reads and
    writes, without fusion.  Meta tensors (the shape trees the layouts
    are resolved from) are not the rank's memory and are not counted."""

    SKIP = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "detach", "alias", "lift_fresh"}

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "aten" and not func.is_view \
                and func._opname not in self.SKIP:
            for t in _tensors((args, kwargs, out)):
                if t.device.type != "meta":
                    self.nbytes += t.numel() * t.element_size()
        return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def trace_cost(arch: str, shape, mesh, unroll_periods: int,
               cfg: Optional[ModelConfig] = None,
               overrides: Optional[dict] = None):
    """One cost trace: (flops, bytes, collective records, kernel calls)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        run, _, _ = lower_cell(arch, shape, mesh,
                               unroll_periods=unroll_periods, cfg=cfg,
                               overrides=overrides)
        flops = FlopCounterMode(display=False)
        nbytes = ByteCount()
        with cost.tallying() as tally, coll.record() as recs, flops, \
                nbytes:
            run()
    return (flops.get_total_flops() + tally.ops,
            nbytes.nbytes + tally.nbytes, list(recs), dict(tally.calls))


def trace_production(arch: str, shape, mesh, *,
                     cfg: Optional[ModelConfig] = None,
                     cache_len: Optional[int] = None,
                     overrides: Optional[dict] = None,
                     opt: Optional[optim.OptConfig] = None):
    """The full-depth trace: (meta, peak live bytes, kernel calls);
    ``cfg``, ``cache_len``, ``overrides`` and ``opt`` as
    ``lower_cell``'s."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    with FakeTensorMode():
        run, meta, held = lower_cell(arch, shape, mesh, cfg=cfg,
                                     cache_len=cache_len,
                                     overrides=overrides, opt=opt)
        tracker = MemTracker()
        tracker.track_external(*held)
        with cost.tallying() as tally, tracker:
            run()
        peak = tracker.get_tracker_snapshot("peak")
    # the rank's device; meta tensors are shape trees, not its memory
    return meta, max((v["Total"] for dev, v in peak.items()
                      if torch.device(dev).type != "meta"), default=0), \
        dict(tally.calls)


def fake_world(size: int):
    """Join a fresh fake world of ``size`` ranks as rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             with_cost: bool = True, verbose: bool = True,
             overrides: Optional[dict] = None, variant: str = "") -> dict:
    """One cell's record; ``overrides`` and ``variant`` (its name,
    ``variant_name``'s) a hillclimb variant's."""
    shape_, _ = MESHES[mesh_kind]
    fake_world(math.prod(shape_))
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                backend="fake")
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "ok": False, "rank": 0}
    if variant:
        rec["variant"] = variant
        rec["overrides"] = {k: str(v) for k, v in (overrides or {}).items()}
    t0 = time.monotonic()
    meta, peak, calls = trace_production(arch, shape_name, mesh,
                                         overrides=overrides)
    rec.update(meta)
    rec.update(analytic(model_for(arch, mesh), SHAPES[shape_name], mesh,
                        overrides))
    rec["trace_s"] = round(time.monotonic() - t0, 1)
    rec["memory"] = {"peak_bytes": int(peak),
                     "hbm_bytes": int(HW["hbm_bytes"]),
                     "fits": bool(peak <= HW["hbm_bytes"])}
    rec["kernel_calls"] = calls
    rec["ok"] = True

    if with_cost and mesh_kind == "single":
        fits = {}
        for k in (1, 2):
            flops, nbytes, recs, kcalls = trace_cost(
                arch, shape_name, mesh, k, overrides=overrides)
            summary = parse(recs)
            fits[k] = {"flops": float(flops), "bytes": float(nbytes),
                       "coll_wire": summary["wire"],
                       "coll_t": summary["t"], "colls": recs}
        n_periods = n_periods_of(configs.get(arch))
        full = {}
        for key in ("flops", "bytes", "coll_wire", "coll_t"):
            b = fits[2][key] - fits[1][key]       # per period
            a = fits[1][key] - b                  # fixed part
            full[key] = a + b * n_periods
            full[key + "_per_period"] = b
            full[key + "_fixed"] = a
        rec["cost_fit"] = full
        rec["cost_points"] = {k: {kk: v[kk] for kk in
                                  ("flops", "bytes", "coll_wire")}
                              for k, v in fits.items()}
        mix: Dict[str, float] = {}
        for c in fits[2]["colls"]:
            mix[c["op"]] = mix.get(c["op"], 0.0) + wire_bytes(c)
        rec["coll_mix_k2"] = mix
        rec["t_compute"] = full["flops"] / HW["peak_flops_bf16"]
        rec["t_memory"] = full["bytes"] / HW["hbm_bw"]
        rec["t_collective"] = full["coll_t"]
        terms = {k: rec[k] for k in ("t_compute", "t_memory",
                                     "t_collective")}
        rec["dominant"] = max(terms, key=terms.get)
    if verbose:
        print(json.dumps({k: rec.get(k) for k in
                          ("arch", "shape", "mesh", "ok", "trace_s")}),
              flush=True)
    return rec


def rec_path(arch: str, shape: str, mesh_kind: str, variant: str = ""
             ) -> Path:
    """A record's file: ``{arch}_{shape}_{mesh}[__{variant}].json``."""
    suffix = f"__{variant}" if variant else ""
    return OUT_DIR / f"{arch}_{shape}_{mesh_kind}{suffix}.json"


def save_rec(rec: dict):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    rec_path(rec["arch"], rec["shape"], rec["mesh"],
             rec.get("variant", "")).write_text(json.dumps(rec, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-cost", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--variant", default="",
                    help="hillclimb variant: comma list of "
                         "moe_dispatch=cumsum, param_gather=bfloat16, "
                         "flat_dp, gather_once, microbatches=N")
    args = ap.parse_args(argv)
    overrides = parse_variant(args.variant)
    variant = variant_name(args.variant)

    if args.all:
        cells = configs.all_cells()
    elif args.arch:
        shapes = [args.shape] if args.shape else \
            list(configs.shapes_for(args.arch))
        cells = [(args.arch, s) for s in shapes]
    else:
        ap.error("--arch or --all")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    torch.set_num_threads(1)
    for mk in meshes:                 # one fake world a mesh size
        for arch, shape in cells:
            out = rec_path(arch, shape, mk, variant)
            if args.skip_done and out.exists() and \
                    json.loads(out.read_text()).get("ok"):
                continue
            try:
                rec = run_cell(arch, shape, mk, with_cost=not args.no_cost,
                               overrides=overrides, variant=variant)
            except Exception as e:
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "mesh": mk, "rank": 0,
                       "ok": False, "error": f"{type(e).__name__}: {e}"}
                if variant:
                    rec["variant"] = variant
                    rec["overrides"] = {k: str(v)
                                        for k, v in overrides.items()}
                failures.append((arch, shape, mk))
            save_rec(rec)
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print("FAILED CELLS:", failures)
        raise SystemExit(1)
    print("all requested cells OK")


if __name__ == "__main__":
    main()
