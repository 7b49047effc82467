"""Rank scenarios for ``tests/test_torch_telemetry.py`` (run by
``torch_ranks.run_ranks``; no JAX)."""
from __future__ import annotations


def sharded_regions(rank, world, args):
    """The sharded step of reduced ``args["arch"]`` on a (data ``world``,
    model 1) mesh, its steps under the CPU profiler: the train regions
    (name, start, end) and the start of each all-reduce."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import Model
    from repro_torch.train import optim
    from repro_torch.train.step import init_state, make_train_step

    mesh = Mesh((world, 1), ("data", "model"), backend="gloo")
    model = Model(configs.reduced(args["arch"]).replace(
        compute_dtype="float32"))
    ocfg = optim.OptConfig()
    state = init_state(model, ocfg, 0, device="cpu", mesh=mesh)
    step = make_train_step(model, ocfg, ParallelConfig(), mesh=mesh)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for batch in args["batches"]:
            state, _ = step(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    names = ("train.step", "train.forward", "train.backward",
             "train.optimizer")
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    return {"regions": sorted((x for x in evs if x[0] in names),
                              key=lambda x: x[1]),
            "all_reduces": [s for n, s, _ in evs if "allreduce" in n]}
