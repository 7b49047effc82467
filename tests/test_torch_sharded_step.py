"""The sharded training step (``make_train_step(..., mesh=)``) against the
unsharded one, and its stored state against the resolver.

One run a module: 4 gloo ranks on the CPU (``torch_ranks``, 120 s
limit) train reduced qwen1.5-0.5b (dense) and reduced
granite-moe-3b-a800m (MoE, capacity factor 16: dropless, as the
reference's sharded test compares it) in f32 on meshes (data 2, model 2),
(data 1, model 4) and (data 4, model 1) (every rank all experts, the aux
sums still the global batch's), 3 AdamW steps from seed 0 on a global batch of
8 x 16, remat "block" (the MoE layers' collectives run again in the
backward).  The unsharded step runs in this process from the same seed
on the same batches.  Each case holds:

* the loss at every step to the unsharded loss at rtol 2e-4 (the
  reference's bound), and the gradient norm;
* every parameter after 1 and 3 steps, gathered, to the unsharded
  step's within 1e-5;
* each rank's stored leaves (params, m) at the resolver's local shapes,
  and its stored bytes (params, m, v, count) equal to
  ``bytes_per_device`` of the state."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.distrib.sharding import (abstract_mesh,  # noqa: E402
                                          bytes_per_device, entry_axes,
                                          tree_specs)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.moe import padded_experts  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.optim import leaves  # noqa: E402
from repro_torch.train.step import (init_state, init_state_axes,  # noqa: E402
                                    leaves_of, make_train_step)
from torch_ranks import run_ranks  # noqa: E402

ARCHS = ("qwen1.5-0.5b", "granite-moe-3b-a800m")
MESHES = ((2, 2), (1, 4), (4, 1))
CASES = {f"{a.split('-')[0]}-{m[0]}x{m[1]}": (a, m) for a in ARCHS
         for m in MESHES}
# eps 1e-3: at AdamW's default 1e-8 an entry whose gradient is below
# about 1e-8 steps by lr·g/(|g| + eps), which turns the last-bit
# differences of the two gradients (the expert shards' partial outputs and
# the token shards' gradients are summed in another order than the whole
# batch's) into parameter differences up to lr
OPT = dict(lr=1e-3, warmup=0, decay_steps=10, eps=1e-3)
N_STEPS, SNAPS = 3, (1, 3)
B, S = 8, 16


def _model(arch, mesh):
    cfg = configs.reduced(arch).replace(compute_dtype="float32")
    if not cfg.moe.num_experts:
        return Model(cfg)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return Model(cfg, e_pad=padded_experts(cfg, mesh[1]))


def _batches(vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(N_STEPS):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


@pytest.fixture(scope="module")
def run():
    cases = {name: dict(arch=arch, mesh=mesh, opt=OPT, remat="block",
                        snap=SNAPS,
                        batches=_batches(configs.reduced(arch).vocab))
             for name, (arch, mesh) in CASES.items()}
    return cases, run_ranks("torch_dist_scenarios", "sharded_step", 4,
                            {"meshes": MESHES, "cases": cases})


@pytest.fixture(scope="module")
def unsharded(run):
    cases, _ = run
    out = {}
    for name, case in cases.items():
        model = _model(case["arch"], case["mesh"])
        ocfg = optim.OptConfig(**OPT)
        state = init_state(model, ocfg, 0, device="cpu")
        step = make_train_step(model, ocfg, ParallelConfig(remat="block"))
        losses, snaps = [], {}
        for i, batch in enumerate(case["batches"]):
            state, met = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
            losses.append({k: float(met[k]) for k in ("loss", "grad_norm")})
            if i + 1 in SNAPS:
                snaps[i + 1] = [t.detach().clone().numpy()
                                for t in leaves(state["params"])]
        out[name] = (losses, snaps)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_unsharded(run, unsharded, name):
    _, ranks = run
    want, _ = unsharded[name]
    for res in ranks:
        for i, (got, w) in enumerate(zip(res[name]["losses"], want)):
            np.testing.assert_allclose(got["loss"], w["loss"], rtol=2e-4,
                                       err_msg=f"step {i + 1}")
            np.testing.assert_allclose(got["grad_norm"], w["grad_norm"],
                                       rtol=2e-4, err_msg=f"step {i + 1}")
            assert got["tokens"] == B * S


@pytest.mark.parametrize("step", SNAPS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_params_match_unsharded(run, unsharded, name, step):
    _, ranks = run
    _, want = unsharded[name]
    got = ranks[0][name]["snaps"][step]
    assert len(got) == len(want[step])
    worst = max(float(np.abs(g - w).max()) for g, w in
                zip(got, want[step]))
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("name", sorted(CASES))
def test_stored_state_is_the_resolvers(run, name):
    cases, ranks = run
    case = cases[name]
    model = _model(case["arch"], case["mesh"])
    mesh = abstract_mesh(case["mesh"], ("data", "model"))
    shapes, axes = init_state_axes(model, optim.OptConfig(**OPT))
    specs = leaves_of(tree_specs(shapes["params"], axes["params"], mesh))
    full = [tuple(t.shape) for t in leaves(shapes["params"])]
    for rank, res in enumerate(ranks):
        coords = {"data": rank // case["mesh"][1],
                  "model": rank % case["mesh"][1]}
        want = []
        for shape, spec in zip(full, specs):
            shape = list(shape)
            for d, entry in enumerate(spec):
                for a in entry_axes(entry):
                    shape[d] //= mesh[a]
            want.append(tuple(shape))
        stored = res[name]["stored"]
        assert stored["params"] == want == stored["m"]
        assert stored["bytes"] == bytes_per_device(shapes, axes, mesh)
        assert coords                      # every rank holds its block


@pytest.mark.parametrize("arch", sorted(configs.names()))
def test_init_keep_sees_each_part_once_and_draws_the_same(arch):
    """``Model.init(keep=)``, which the sharded state uses to keep its
    blocks one layer at a time, hands over every part of the tree once,
    in the order it is drawn, and draws the same weights as without it."""
    model = Model(configs.reduced(arch))
    seen = []

    def keep(path, part):
        seen.append(path)
        return part
    got = model.init(3, device="cpu", keep=keep)
    want = model.init(3, device="cpu")
    cfg = model.cfg
    parts = ([("embed",)] + [("layers", i) for i in range(cfg.n_layers)]
             + [("final_norm",)])
    if cfg.n_enc_layers:
        parts += [("encoder", "layers", i)
                  for i in range(cfg.n_enc_layers)]
        parts += [("encoder", "final_norm")]
    assert seen == parts
    assert len(leaves(got)) == len(leaves(want))
    for g, w in zip(leaves(got), leaves(want)):
        assert torch.equal(g, w)
