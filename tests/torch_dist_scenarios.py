"""The scenarios that ``torch_ranks.run_ranks`` runs as gloo ranks on the
CPU, one function a test module, each ``(rank, world, args) -> results``.
Nothing here imports JAX: the tests hold the results against the
reference in the parent process."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.distrib import collectives as coll
from repro_torch.distrib.pipeline import pipeline_apply
from repro_torch.distrib.sharding import (entry_axes, gather_block,
                                         local_block)
from repro_torch.launch.mesh import Mesh, make_local_mesh, \
    make_production_mesh


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# collectives, the mesh and the resolver's blocks
# ---------------------------------------------------------------------------
def collectives(rank, world, args):
    out = {}
    data4 = make_local_mesh(1, backend="gloo")            # (data 4, model 1)
    out["data4"] = dict(coords=data4.coords, shape=data4.shape)
    for name, x in args["psum"].items():
        o, e = coll.compressed_psum(_t(x[rank]), data4, "data")
        out[f"psum/{name}"] = (o.numpy(), e.numpy())

    # the reference test's error-feedback regression toy
    Xd, yd, wt = (_t(args["toy"][k]) for k in ("X", "y", "w"))
    w1 = torch.zeros(8)
    w2 = torch.zeros(8)
    err = torch.zeros(8)

    def grad(w, X, y):
        return X.T @ (X @ w - y) / y.numel()
    for _ in range(60):
        g = torch.stack([grad(w1, Xd[i], yd[i]) for i in range(4)]).mean(0)
        w1 = w1 - 0.3 * g
        g2, err = coll.compressed_psum(grad(w2, Xd[rank], yd[rank]) + err,
                                       data4, "data")
        w2 = w2 - 0.3 * g2
    out["toy"] = (float(torch.linalg.norm(w1 - wt)),
                  float(torch.linalg.norm(w2 - wt)), w2.numpy())
    tree = {"a": _t(args["tree"]["a"][rank]),
            "b": [_t(args["tree"]["b"][rank])]}
    red, errs = coll.compressed_allreduce_tree(tree, None, data4, "data")
    red2, _ = coll.compressed_allreduce_tree(tree, errs, data4, "data")
    out["tree"] = (red["a"].numpy(), red["b"][0].numpy(),
                   errs["a"].numpy(), red2["a"].numpy())

    seq4 = Mesh((1, 4), ("data", "model"), backend="gloo")
    q, k, v = (_t(args["sp"][n]) for n in ("q", "k", "v"))
    n = k.shape[1] // 4
    for softcap in args["softcaps"]:
        got = coll.sp_decode_attention(q, k[:, rank * n:(rank + 1) * n],
                                       v[:, rank * n:(rank + 1) * n], seq4,
                                       seq_axis="model", softcap=softcap)
        out[f"sp/{softcap}"] = got.numpy()

    grid = Mesh((2, 2), ("data", "model"), backend="gloo")
    out["grid"] = dict(coords=grid.coords,
                       index=grid.axis_index(("data", "model")))
    for name, (x, spec, axes) in args["blocks"].items():
        whole = _t(x)
        block = local_block(whole, spec, grid)
        back = gather_block(block, spec, grid, axes)
        out[f"block/{name}"] = (block.numpy(), back.numpy())
    for op in ("sum", "max", "min"):
        out[f"reduce/{op}"] = coll.all_reduce(
            torch.tensor([rank, -rank], dtype=torch.bfloat16), grid,
            ("data", "model"), op).float().numpy()

    refused = {}
    for name, make in (
            ("production", lambda: make_production_mesh(backend="gloo")),
            ("multi_pod", lambda: make_production_mesh(True,
                                                       backend="gloo")),
            ("nccl", lambda: make_local_mesh(1, backend="nccl")),
            ("backend", lambda: make_local_mesh(1, backend="mpi")),
            ("model_axis", lambda: make_local_mesh(3, backend="gloo"))):
        try:
            make()
            refused[name] = None
        except (RuntimeError, ValueError) as e:
            refused[name] = type(e).__name__
    out["refused"] = refused
    return out


# ---------------------------------------------------------------------------
# the pipeline runner
# ---------------------------------------------------------------------------
def pipeline(rank, world, args):
    mesh = Mesh((world,), ("stage",), backend="gloo")
    out = {}
    for name, (Ws, x) in args.items():
        W = _t(Ws[rank])
        out[name] = pipeline_apply(lambda w, h: torch.tanh(h @ w), W, _t(x),
                                   mesh, stage_axis="stage").numpy()
    return out


# ---------------------------------------------------------------------------
# the expert-parallel MoE layer
# ---------------------------------------------------------------------------
def moe_layer(rank, world, args):
    from repro_torch import configs
    from repro_torch.models.moe import MoESpmd, moe_apply
    meshes = {shape: Mesh(shape, ("data", "model"), backend="gloo")
              for shape in args["meshes"]}
    out = {}
    for name, case in args["cases"].items():
        mesh = meshes[case["mesh"]]
        cfg = configs.reduced(case["arch"]).replace(
            compute_dtype="float32")
        n_tok, n_ex = mesh.shape["data"], mesh.shape["model"]
        i_tok, i_ex = mesh.coords["data"], mesh.coords["model"]
        x = _t(case["x"])
        b = x.shape[0] // n_tok
        x = x[i_tok * b:(i_tok + 1) * b].clone().requires_grad_()
        gy = _t(case["gy"])[i_tok * b:(i_tok + 1) * b]
        params = {}
        for key, val in case["params"].items():
            if isinstance(val, dict):
                params[key] = {k: _t(v).requires_grad_()
                               for k, v in val.items()}
                continue
            t = _t(val)
            if key != "router":
                e = t.shape[0] // n_ex
                t = t[i_ex * e:(i_ex + 1) * e].clone()
            params[key] = t.requires_grad_()
        spmd = MoESpmd(mesh, case["token_axes"], "model")
        y, aux = moe_apply(cfg, params, x, spmd=spmd,
                           capacity_factor=case["cf"])
        # this token shard's term of the objective the step would average
        loss = n_tok * (y * gy).sum() + aux["moe_lb"] + aux["moe_z"]
        loss.backward()
        grads = {k: (v.grad.numpy() if not isinstance(v, dict) else
                     {kk: vv.grad.numpy() for kk, vv in v.items()})
                 for k, v in params.items()}
        out[name] = dict(y=y.detach().numpy(), lb=float(aux["moe_lb"]),
                         z=float(aux["moe_z"]), dx=x.grad.numpy(),
                         grads=grads, tok=i_tok, ex=i_ex)
    return out


# ---------------------------------------------------------------------------
# the sharded training step
# ---------------------------------------------------------------------------
def sharded_step(rank, world, args):
    meshes = {shape: Mesh(shape, ("data", "model"), backend="gloo")
              for shape in args["meshes"]}
    return {name: _step_case(rank, meshes[case["mesh"]], case)
            for name, case in args["cases"].items()}


def _step_model(arch, mesh_shape, over=None):
    """Reduced ``arch`` in f32 (``over`` replacing config fields), a MoE
    config dropless (capacity factor 16) with its experts padded to the
    model axis."""
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.moe import padded_experts
    cfg = configs.reduced(arch).replace(compute_dtype="float32",
                                        **(over or {}))
    if not cfg.moe.num_experts:
        return Model(cfg)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return Model(cfg, e_pad=padded_experts(cfg, mesh_shape[1]))


def _step_case(rank, mesh, case):
    """The sharded steps of one case: its stored state, each step's
    metrics and (rank 0) the gathered parameters after the steps in
    ``case["snap"]``.  A case may name ``microbatches``, ``flat_dp``
    (the flat rules), ``batch_axes`` and ``param_gather`` (a dtype name)
    beside its optimizer."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distrib.sharding import tree_specs
    from repro_torch.distrib.tensor_parallel import flat_dp_rules
    from repro_torch.train import optim
    from repro_torch.train.optim import leaves
    from repro_torch.train.step import (init_state, leaves_of,
                                        make_train_step)
    model = _step_model(case["arch"], case["mesh"], case.get("over"))
    ocfg = optim.OptConfig(**case["opt"])
    par = ParallelConfig(remat=case["remat"],
                         microbatches=case.get("microbatches", 1),
                         param_gather_dtype=case.get("param_gather", ""))
    seq = case.get("seq_parallel", False)
    rules = flat_dp_rules(mesh) if case.get("flat_dp") else None
    state = init_state(model, ocfg, 0, device="cpu", mesh=mesh, rules=rules)
    opt = {k: leaves(v) for k, v in state["opt"].items() if k != "count"}
    stored = {"params": [tuple(t.shape) for t in leaves(state["params"])],
              **{k: [tuple(t.shape) for t in v] for k, v in opt.items()},
              "bytes": sum(t.numel() * t.element_size() for t in
                           leaves(state["params"])
                           + [t for v in opt.values() for t in v]
                           + [state["opt"]["count"]])}
    step = make_train_step(model, ocfg, par, mesh, seq_parallel=seq,
                           rules=rules, batch_axes=case.get("batch_axes"))
    specs = leaves_of(tree_specs(model.init(device="meta"),
                                 model.param_axes(), mesh, rules))
    losses, snaps, colls = [], {}, None
    for i, batch in enumerate(case["batches"]):
        with coll.record() as recs:
            state, met = step(state, {k: _t(v) for k, v in batch.items()})
        colls = list(recs) if colls is None else colls
        losses.append({k: float(met[k]) for k in
                       ("loss", "grad_norm", "ce", "tokens")})
        if i + 1 in case["snap"]:
            whole = [gather_block(b, s, mesh) for b, s in
                     zip(leaves(state["params"]), specs)]
            snaps[i + 1] = [w.clone().numpy() for w in whole] \
                if rank == 0 else None
    return dict(stored=stored, losses=losses, snaps=snaps,
                collectives=colls)


def param_gather_grads(rank, world, args):
    """The sharded gradients under ``param_gather`` on a gloo (data 2,
    model 2) mesh from the whole parameters ``args["params"]`` (numpy
    leaves in ``leaves`` order): (loss, metrics, rank 0's gradients
    gathered whole)."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.train.optim import leaves, tree_map
    from repro_torch.train.step import leaves_of, make_sharded_grads
    mesh = Mesh((2, 2), ("data", "model"), backend="gloo")
    model = _step_model(args["arch"], (2, 2))
    par = ParallelConfig(remat=args["remat"],
                         param_gather_dtype=args["param_gather"])
    grads_of = make_sharded_grads(model, par, mesh)
    specs = leaves_of(grads_of.layout.specs)
    whole = iter(_t(a) for a in args["params"])
    blocks = tree_map(lambda _: next(whole), model.init(device="meta"))
    spec_it = iter(specs)
    blocks = tree_map(lambda t: local_block(t, next(spec_it), mesh), blocks)
    batch = {k: _t(v) for k, v in args["batch"].items()}
    with coll.record() as recs:
        loss, metrics, grads = grads_of(blocks, batch)
    out = [gather_block(g, s, mesh).numpy() for g, s in
           zip(leaves(grads), specs)]
    return dict(loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=out if rank == 0 else None, collectives=list(recs),
                dtypes=sorted({str(g.dtype) for g in leaves(grads)}))


# ---------------------------------------------------------------------------
# tensor parallelism: the collective forms, the layers, the step
# ---------------------------------------------------------------------------
def _by(form, fns, x, spec, mesh, axes):
    """``x`` through ``fns[form]`` along each dimension of ``spec`` that
    the axes ``axes`` split (``gather_block``'s and
    ``reduce_scatter_block``'s loops, in a chosen form)."""
    for d, entry in enumerate(spec):
        take = tuple(a for a in entry_axes(entry) if a in axes)
        if take:
            x = fns[form](x, mesh, take, d)
    return x


def _forms(mesh, case, rank):
    """One collective case in both forms: the gathered block and the
    reduce-scatter of this rank's seeded whole tensor; then
    ``GatherFromAxes`` / ``ReduceScatterToAxes`` forward and backward
    in the form the mesh and device pick."""
    gathers = {"direct": coll._gather_direct,
               "all_reduce": coll._gather_by_all_reduce}
    scatters = {"direct": coll._scatter_direct,
                "all_reduce": coll._scatter_by_all_reduce}
    spec, axes, same = case["spec"], case["axes"], case.get("same", ())
    whole = _t(case["x"])
    block = local_block(whole, spec, mesh)
    # this rank's tensor, whole over ``axes``
    mine = local_block(_t(case["g"][rank]), spec, mesh,
                       tuple(a for a in mesh.axis_names if a not in axes))
    out = {}
    for form in ("direct", "all_reduce"):
        out[f"gather/{form}"] = _by(form, gathers, block, spec, mesh,
                                    axes).numpy()
        red = _by(form, scatters, mine, spec, mesh, axes)
        rest = tuple(a for a in axes
                     if not any(a in entry_axes(e) for e in spec))
        if rest:
            red = coll.all_reduce(red, mesh, rest)
        out[f"scatter/{form}"] = red.numpy()
    out["form"] = coll.collective_form(mesh, block)
    x = block.clone().requires_grad_()
    y = coll.GatherFromAxes.apply(x, spec, mesh, axes, same)
    gy = local_block(_t(case["g"][rank]), spec, mesh,
                     tuple(a for a in mesh.axis_names
                           if a not in axes + tuple(same)))
    (y * gy).sum().backward()
    out["gather_fn"] = (y.detach().numpy(), x.grad.numpy())
    if not same:
        z = mine.clone().requires_grad_()
        w = coll.ReduceScatterToAxes.apply(z, spec, mesh, axes)
        (w * block).sum().backward()
        out["scatter_fn"] = (w.detach().numpy(), z.grad.numpy())
    return out


def _local_params(params, axes_tree, mesh):
    """Each whole leaf's block over the model axis only, as the sharded
    step's gathers give them to the layers, each a leaf of its own."""
    from repro_torch.distrib.sharding import DEFAULT_RULES, spec_for
    out = {}
    for key, val in params.items():
        t = _t(val)
        spec = spec_for(tuple(t.shape), axes_tree[key], mesh, DEFAULT_RULES)
        out[key] = local_block(t, spec, mesh, ("model",)).requires_grad_()
    return out


def _grads(tree):
    """The gradients of the leaves the computation used."""
    return {k: v.grad.numpy() for k, v in tree.items()
            if v.grad is not None}


def _layer_case(mesh, case):
    """One attention, MLP, SSD or RG-LRU sub-layer on the rank's share of
    the model axis (``Split``), forward and backward."""
    from repro_torch.distrib.tensor_parallel import Split
    from repro_torch.models import attention as attn
    from repro_torch.models.common import mlp, mlp_axes
    from repro_torch.models.rglru_block import rglru_axes, rglru_block_apply
    from repro_torch.models.ssd_block import ssd_axes, ssd_block_apply
    cfg = _tp_cfg(case)
    split = Split(mesh, "model")
    x = _t(case["x"]).requires_grad_()
    gy = _t(case["gy"])
    out = {}
    if case["what"] in ("ssd", "rglru"):
        axes, apply = ((ssd_axes, ssd_block_apply) if case["what"] == "ssd"
                       else (rglru_axes, rglru_block_apply))
        p = _local_params(case["params"], axes(cfg), mesh)
        y = apply(cfg, p, x, tp=split)[0]
    elif case["what"] == "mlp":
        p = _local_params(case["params"], mlp_axes(cfg), mesh)
        y = mlp(cfg, p, x, tp=split)
    elif case["what"] == "cross":
        p = _local_params(case["params"], attn.attn_axes(cfg), mesh)
        mem = _t(case["memory"]).requires_grad_()
        k, v = attn.cross_kv(cfg, p, mem, tp=split)
        y = attn.cross_attn(cfg, p, x, k, v, tp=split)
    else:
        p = _local_params(case["params"], attn.attn_axes(cfg), mesh)
        y = attn.attn_train(cfg, p, x, kind=case["kind"], tp=split)
    (y * gy).sum().backward()
    out.update(y=y.detach().numpy(), dx=x.grad.numpy(), grads=_grads(p))
    if case["what"] == "cross":
        out["dmem"] = mem.grad.numpy()
    return out


def _tp_cfg(case):
    """The case's reduced config, ``over`` replacing its fields (an
    ``ssm`` dict replacing the SSM config's)."""
    from repro_torch import configs
    over = dict(case["over"])
    cfg = configs.reduced(case["arch"])
    if "ssm" in over:
        over["ssm"] = dataclasses.replace(cfg.ssm, **over["ssm"])
    return cfg.replace(**over)


def _vocab_case(mesh, case):
    """The vocabulary-parallel lookup and loss on the rank's slice of the
    vocabulary, forward and backward."""
    from repro_torch.distrib.tensor_parallel import Split
    from repro_torch.models.common import chunked_ce_loss, embed_tokens
    cfg = _tp_cfg(case)
    split = Split(mesh, "model")
    n, r = split.n, split.rank

    def mine(name, dim):
        t = _t(case[name])
        b = t.shape[dim] // n
        return t.narrow(dim, r * b, b).clone().requires_grad_()
    p = {"embedding": mine("table", 0)}
    if "head" in case:
        p["head"] = mine("head", 1)
    h = _t(case["h"]).requires_grad_()
    loss, met = chunked_ce_loss(cfg, p, h, _t(case["targets"]),
                                chunk=case["chunk"], z_coef=case["z_coef"],
                                tp=split)
    loss.backward()
    look = {"embedding": mine("table", 0)}
    emb = embed_tokens(cfg, look, _t(case["tokens"]), tp=split)
    (emb.float() * _t(case["gy"])).sum().backward()
    return dict(loss=float(loss), ce=float(met["ce"]),
                z=float(met["z_loss"]), tokens=int(met["tokens"]),
                dh=h.grad.numpy(), grads=_grads(p),
                emb=emb.detach().float().numpy(),
                demb=look["embedding"].grad.numpy())


def _scope_case(rank, mesh, case):
    """One remat "block" forward and backward of the sharded layout,
    watching each gathered leaf: the gathers counted by (sub-layer,
    axes), and at each gather the parts other than the one gathering
    (and the embedding, and an encoder's final norm, which its memory's
    norm keeps for the decoder) that still hold a live gathered leaf."""
    import weakref

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distrib.tensor_parallel import TensorParallel
    from repro_torch.train import optim
    from repro_torch.train.step import (init_state, loss_and_grads,
                                        make_moe_spmd)
    keep = {("embed",), ("encoder", "final_norm")}
    live, worst = [], []

    def part(path):
        n = 3 if path[0] == "encoder" and path[1] == "layers" else 2
        return tuple(path[:n]) if path[0] in ("layers", "encoder") \
            else tuple(path[:1])

    class Watched(TensorParallel):
        def _gather(self, part_, spec, path):
            out = super()._gather(part_, spec, path)
            if torch.is_tensor(out):
                now = part(path)
                others = ({p for p, ref in live if ref() is not None}
                          - keep - {now})
                worst.append(sorted(map(str, others)))
                live.append((now, weakref.ref(out)))
            return out

    model = _step_model(case["arch"], case["mesh"])
    tp = Watched(model, mesh, ("data",), "model",
                 moe=make_moe_spmd(model.cfg, ParallelConfig(), mesh))
    blocks = init_state(model, optim.OptConfig(), 0, device="cpu",
                        mesh=mesh)["params"]
    rows = {k: local_block(_t(v), ("data",), mesh)
            for k, v in case["batch"].items()}
    loss, _, grads = loss_and_grads(model, blocks, rows, remat="block",
                                    spmd=tp)
    return dict(gathers={f"{k[0]}|{','.join(k[1])}": n
                         for k, n in tp.gathers.items()},
                others=[w for w in worst if w], n_gathers=len(worst),
                loss=float(loss))


def tensor_parallel(rank, world, args):
    meshes = {shape: Mesh(shape, ("data", "model"), backend="gloo")
              for shape in args["meshes"]}
    out = {"forms": {}, "layers": {}, "vocab": {}, "steps": {},
           "scope": {}}
    for name, case in args["forms"].items():
        out["forms"][name] = _forms(meshes[case["mesh"]], case, rank)
    for name, case in args["layers"].items():
        out["layers"][name] = _layer_case(meshes[case["mesh"]], case)
    for name, case in args["vocab"].items():
        out["vocab"][name] = _vocab_case(meshes[case["mesh"]], case)
    for name, case in args["scope"].items():
        out["scope"][name] = _scope_case(rank, meshes[case["mesh"]], case)
    for name, case in args["steps"].items():
        out["steps"][name] = _step_case(rank, meshes[case["mesh"]], case)
    out["coords"] = {shape: dict(m.coords) for shape, m in meshes.items()}
    return out


# ---------------------------------------------------------------------------
# sequence parallelism: the steps, the stream's shard, the collectives
# ---------------------------------------------------------------------------
class _Counted:
    """Every collective of ``torch.distributed`` the port calls, counted
    by kind: calls and the bytes of the larger of its first two tensors
    (as ``chip_smoke.py``'s ``CollectiveClock``, ``tools/tp_bytes.py``)."""

    KINDS = ("all_reduce", "all_gather_single", "all_gather_into_tensor",
             "reduce_scatter_single", "reduce_scatter_tensor")

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.by_kind, self._orig = dist, {}, {}

    def __enter__(self):
        for kind in self.KINDS:
            if hasattr(self.dist, kind):
                self._orig[kind] = getattr(self.dist, kind)
                setattr(self.dist, kind, self._wrap(kind, self._orig[kind]))
        return self

    def _wrap(self, kind, fn):
        def counted(*a, **kw):
            rec = self.by_kind.setdefault(kind, {"calls": 0, "bytes": 0})
            rec["calls"] += 1
            rec["bytes"] += max(t.numel() * t.element_size()
                                for t in a[:2] if torch.is_tensor(t))
            return fn(*a, **kw)
        return counted

    def __exit__(self, *exc):
        for kind, fn in self._orig.items():
            setattr(self.dist, kind, fn)


def _shard_case(mesh, case):
    """One remat "block" forward and backward of the sequence-parallel
    layout, each block's residual-stream input (its positions) recorded
    in the forward and in the recompute."""
    from repro_torch.models import Model
    from repro_torch.train.step import loss_and_grads
    model = _step_model(case["arch"], case["mesh"])
    tp, blocks = _layout(model, mesh, True)
    seen = []
    block = Model._block

    def watched(self, p, x, *a, **kw):
        seen.append(tuple(x.shape))
        return block(self, p, x, *a, **kw)
    rows = {k: local_block(_t(v), ("data",), mesh)
            for k, v in case["batch"].items()}
    Model._block = watched
    try:
        loss_and_grads(model, blocks, rows, remat="block", spmd=tp)
    finally:
        Model._block = block
    return dict(inputs=seen, layers=model.cfg.n_layers)


def _layout(model, mesh, seq_parallel):
    """(the step's ``TensorParallel`` layout, this rank's stored blocks)."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distrib.tensor_parallel import TensorParallel
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_moe_spmd
    tp = TensorParallel(model, mesh, ("data",), "model",
                        moe=make_moe_spmd(model.cfg, ParallelConfig(), mesh),
                        seq_parallel=seq_parallel)
    blocks = init_state(model, optim.OptConfig(), 0, device="cpu",
                        mesh=mesh)["params"]
    return tp, blocks


def _count_case(mesh, case):
    """The collectives of one sharded step, counted by kind."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import Model
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch import configs
    model = Model(configs.reduced(case["arch"]))
    ocfg = optim.OptConfig()
    state = init_state(model, ocfg, 0, device="cpu", mesh=mesh)
    step = make_train_step(model, ocfg, ParallelConfig(remat=case["remat"]),
                           mesh, seq_parallel=case["seq_parallel"])
    batch = {k: _t(v) for k, v in case["batch"].items()}
    with _Counted() as counted:
        step(state, batch)
    return counted.by_kind


def seq_parallel(rank, world, args):
    meshes = {shape: Mesh(shape, ("data", "model"), backend="gloo")
              for shape in args["meshes"]}
    out = {"steps": {}, "shard": {}, "counts": {}}
    for name, case in args["shard"].items():
        out["shard"][name] = _shard_case(meshes[case["mesh"]], case)
    for name, case in args["counts"].items():
        out["counts"][name] = _count_case(meshes[case["mesh"]], case)
    for name, case in args["steps"].items():
        out["steps"][name] = _step_case(rank, meshes[case["mesh"]], case)
    return out


# ---------------------------------------------------------------------------
# serving on a mesh: sharded prefill and decode against one process's
# ---------------------------------------------------------------------------
def _serve_model(arch, n_model):
    """Reduced ``arch`` in f32, a MoE config's experts padded to the
    model axis."""
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.models.moe import padded_experts
    cfg = configs.reduced(arch).replace(compute_dtype="float32")
    if not cfg.moe.num_experts:
        return Model(cfg)
    return Model(cfg, e_pad=padded_experts(cfg, n_model))


def _greedy(model, params, tokens, frontend, cache_len, steps, **kw):
    """(prefill logits, each decode step's logits, the greedy tokens)."""
    logits, cache = model.prefill(params, tokens, cache_len=cache_len,
                                  frontend=frontend, **kw.get("prefill", {}))
    pos = tokens.shape[1] + (model.cfg.frontend_seq
                             if model.cfg.family == "vlm" else 0)
    steps_out, picked = [], []
    nxt = logits.argmax(-1)
    for i in range(steps):
        picked.append(nxt)
        out, cache = model.decode_step(params, cache, nxt[:, None], pos + i,
                                       **kw.get("decode", {}))
        steps_out.append(out)
        nxt = out.argmax(-1)
    return logits, torch.stack(steps_out), torch.stack(picked, 1), cache


def serve_layout(model, mesh, batch, rules):
    """The serving ``TensorParallel`` of ``model`` on ``mesh``: the batch
    over the data axis where it divides, the experts over the model
    axis."""
    from repro_torch.distrib.tensor_parallel import TensorParallel
    from repro_torch.models.moe import MoESpmd
    batch_axes = ("data",) if batch % mesh.shape["data"] == 0 else ()
    moe = None
    if model.cfg.moe.num_experts:
        moe = MoESpmd(mesh=mesh, token_axes=batch_axes,
                      expert_axis="model" if mesh.shape["model"] > 1
                      else None)
    return TensorParallel(model, mesh, ("data",), "model", moe=moe,
                          batch_axes=batch_axes, rules=rules)


def _serve_case(rank, mesh, case):
    from repro_torch.train import optim
    from repro_torch.train.step import init_state
    model = _serve_model(case["arch"], mesh.shape["model"])
    tokens = _t(case["tokens"])
    frontend = (None if case.get("frontend") is None
                else _t(case["frontend"]))
    out = {}
    tp = serve_layout(model, mesh, tokens.shape[0], case.get("rules"))
    if case.get("weights") is not None:
        # weights from elsewhere (the reference's, bridged): every rank
        # keeps its blocks
        from repro_torch.models import params_from_numpy
        from repro_torch.train.step import _blocks
        blocks = _blocks(params_from_numpy(case["weights"], device="cpu"),
                         tp.specs, mesh)
    else:
        if rank == 0:
            params = model.init(0, device="cpu")
            out["whole"] = [t.numpy() for t in _greedy(
                model, params, tokens, frontend, case["cache_len"],
                case["steps"])[:3]]
        blocks = init_state(model, optim.OptConfig(), 0, device="cpu",
                            mesh=mesh)["params"]
    rows = (lambda t: t) if not tp.batch_axes else (
        lambda t: local_block(t, (tp.batch_axes,), mesh))
    from repro_torch.distrib import collectives as coll
    with coll.record() as recs:
        got = _greedy(model, blocks, rows(tokens),
                      None if frontend is None else rows(frontend),
                      case["cache_len"], case["steps"],
                      prefill={"spmd": tp}, decode={
                          "spmd": tp, "cache_len": case["cache_len"]})
    out["sharded"] = [t.numpy() for t in got[:3]]
    out["batch_axes"] = tp.batch_axes
    out["n_batch"] = mesh.axis_size(tp.batch_axes)
    out["coords"] = dict(mesh.coords)
    out["cache"] = {k: tuple(v.shape) for k, v in got[3].items()}
    out["colls"] = recs
    return out


def sharded_serve(rank, world, args):
    meshes = {shape: Mesh(shape, ("data", "model"), backend="gloo")
              for shape in args["meshes"]}
    return {name: _serve_case(rank, meshes[case["mesh"]], case)
            for name, case in args["cases"].items()}


# ---------------------------------------------------------------------------
# the dry run's cells as a real run: the collectives they issue
# ---------------------------------------------------------------------------
def dry_collectives(rank, world, args):
    """Each cell of ``args`` (name -> (arch, kind, batch, seq[, variant]))
    at reduced size, run for real by ``launch.dryrun.lower_cell`` on a
    gloo (data 2, model 2) mesh: the collectives it issues, in order."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distrib import collectives as coll
    from repro_torch.launch import dryrun
    mesh = Mesh((2, 2), ("data", "model"), backend="gloo")
    out = {}
    for name, (arch, kind, batch, seq, *variant) in args.items():
        shape = ShapeSpec(name=name, kind=kind, seq_len=seq,
                          global_batch=batch)
        run, _, _ = dryrun.lower_cell(
            arch, shape, mesh, cfg=configs.reduced(arch),
            overrides=dryrun.parse_variant(variant[0] if variant else ""))
        with coll.record() as recs:
            run()
        out[name] = list(recs)
    return out
