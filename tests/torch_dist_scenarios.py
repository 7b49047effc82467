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
from repro_torch.distrib.sharding import gather_block, local_block
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
    from repro_torch import configs
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distrib.sharding import tree_specs
    from repro_torch.models import Model
    from repro_torch.models.moe import padded_experts
    from repro_torch.train import optim
    from repro_torch.train.optim import leaves
    from repro_torch.train.step import (init_state, leaves_of,
                                        make_train_step)
    meshes = {shape: Mesh(shape, ("data", "model"), backend="gloo")
              for shape in args["meshes"]}
    out = {}
    for name, case in args["cases"].items():
        mesh = meshes[case["mesh"]]
        cfg = configs.reduced(case["arch"]).replace(
            compute_dtype="float32")
        if cfg.moe.num_experts:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=16.0))
            model = Model(cfg, e_pad=padded_experts(cfg,
                                                    mesh.shape["model"]))
        else:
            model = Model(cfg)
        ocfg = optim.OptConfig(**case["opt"])
        par = ParallelConfig(remat=case["remat"])
        state = init_state(model, ocfg, 0, device="cpu", mesh=mesh)
        stored = {"params": [tuple(t.shape) for t in
                             leaves(state["params"])],
                  "m": [tuple(t.shape) for t in leaves(state["opt"]["m"])],
                  "bytes": sum(t.numel() * t.element_size() for t in
                               leaves(state["params"])
                               + leaves(state["opt"]["m"])
                               + leaves(state["opt"]["v"])
                               + [state["opt"]["count"]])}
        step = make_train_step(model, ocfg, par, mesh)
        specs = leaves_of(tree_specs(model.init(device="meta"),
                                     model.param_axes(), mesh))
        losses, snaps = [], {}
        for i, batch in enumerate(case["batches"]):
            state, met = step(state, {k: _t(v) for k, v in batch.items()})
            losses.append({k: float(met[k]) for k in
                           ("loss", "grad_norm", "ce", "tokens")})
            if i + 1 in case["snap"]:
                whole = [gather_block(b, s, mesh) for b, s in
                         zip(leaves(state["params"]), specs)]
                snaps[i + 1] = [w.clone().numpy() for w in whole] \
                    if rank == 0 else None
        out[name] = dict(stored=stored, losses=losses, snaps=snaps)
    return out
