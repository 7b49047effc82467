"""The sharded training step's optimizer and variants against the
unsharded step and the reference, on the CPU.

One run of 4 gloo ranks (``torch_ranks``) trains, from seed 0, 3 steps
on global batches of 8 x 16 in f32, remat "block", at
``test_torch_sharded_step.py``'s bounds (the loss and the gradient norm
at rtol 2e-4 at every step, every parameter within 1e-5 after 1 and 3
steps) against the unsharded step from the same seed on the same
batches:

* Adafactor (``OptConfig(name="adafactor")``) on meshes (data 2, model
  2), (1, 4) and (4, 1), reduced qwen1.5-0.5b and reduced
  granite-moe-3b-a800m (dropless): its stored bytes are the reference's
  ``bytes_per_device`` of its Adafactor state plus exactly the copies of
  the stacked norm scales' columns (``adafactor_column_copies``), its
  collectives a step ``tools/tp_bytes.py``'s (the two rounds of factor
  sums included);
* ``microbatches=2`` on (2, 2), reduced qwen, against the unsharded
  step at 2 microbatches: microbatch i is the global rows [i·B/2,
  (i+1)·B/2), as the reference takes them (before, each rank split its
  own rows and the metrics came from other rows);
* ``flat_dp`` (every axis data-parallel) on (2, 2), reduced qwen and
  granite, and granite with the batch split over the data axis alone
  (``batch_axes``: the model axis's ranks hold the same rows, as a
  production batch that does not split over every rank).

Beside it, the ``param_gather=bfloat16`` gradients on (2, 2) (4 gloo
ranks) against ``jax.value_and_grad`` of the reference's ``loss_fn``
over its ``cast_params``'d parameters, on the same weights through the
bridge, at ``chip_smoke.py``'s ``GRAD_TOL`` for bf16 (2e-2 + 2⁻⁷ of
each leaf's largest entry), and every factored leaf's row and column
placed by the resolver where its leaf's blocks imply, for every config
on the production and the test meshes, under the default and the flat
rules.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.distrib.sharding import (DEFAULT_RULES,  # noqa: E402
                                          abstract_mesh, bytes_per_device,
                                          merge_rules, spec_for,
                                          tree_specs)
from repro_torch.distrib.tensor_parallel import flat_dp_rules  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.moe import padded_experts  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.optim import leaves  # noqa: E402
from repro_torch.train.step import (adafactor_column_copies,  # noqa: E402
                                    init_state, init_state_axes, leaves_of,
                                    make_train_step)
from torch_ranks import run_ranks  # noqa: E402

QWEN, GRANITE = "qwen1.5-0.5b", "granite-moe-3b-a800m"
MESHES = ((2, 2), (1, 4), (4, 1))
OPT = dict(lr=1e-3, warmup=0, decay_steps=10, eps=1e-3)
ADA = dict(OPT, name="adafactor")
N_STEPS, SNAPS = 3, (1, 3)
B, S = 8, 16
CASES = {
    **{f"adafactor-{a.split('-')[0]}-{m[0]}x{m[1]}":
       dict(arch=a, mesh=m, opt=ADA) for a in (QWEN, GRANITE)
       for m in MESHES},
    "micro2-qwen-2x2": dict(arch=QWEN, mesh=(2, 2), opt=OPT,
                            microbatches=2),
    "flat-qwen-2x2": dict(arch=QWEN, mesh=(2, 2), opt=OPT, flat_dp=True),
    "flat-granite-2x2": dict(arch=GRANITE, mesh=(2, 2), opt=OPT,
                             flat_dp=True),
    # the batch over the data axis alone: the model axis's two ranks
    # hold the same rows (a batch that does not split over every rank)
    "flat-granite-2x2-rows": dict(arch=GRANITE, mesh=(2, 2), opt=OPT,
                                  flat_dp=True, batch_axes=("data",)),
}
# chip_smoke.py's GRAD_TOL for bf16
GRAD_TOL_BF16 = 2e-2 + 2.0 ** -7


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
    cases = {name: dict(case, remat="block", snap=SNAPS,
                        batches=_batches(configs.reduced(case["arch"]).vocab))
             for name, case in CASES.items()}
    return cases, run_ranks("torch_dist_scenarios", "sharded_step", 4,
                            {"meshes": MESHES, "cases": cases})


@pytest.fixture(scope="module")
def unsharded(run):
    cases, _ = run
    out = {}
    for name, case in cases.items():
        model = _model(case["arch"], case["mesh"])
        ocfg = optim.OptConfig(**case["opt"])
        state = init_state(model, ocfg, 0, device="cpu")
        step = make_train_step(model, ocfg, ParallelConfig(
            remat="block", microbatches=case.get("microbatches", 1)))
        losses, snaps = [], {}
        for i, batch in enumerate(case["batches"]):
            state, met = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
            losses.append({k: float(met[k]) for k in
                           ("loss", "grad_norm", "ce", "tokens")})
            if i + 1 in SNAPS:
                snaps[i + 1] = [t.detach().clone().numpy()
                                for t in leaves(state["params"])]
        out[name] = (losses, snaps)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_metrics_match_unsharded(run, unsharded, name):
    """The loss and gradient norm at rtol 2e-4; ``ce`` and the token
    count too, which under microbatches are the last microbatch's."""
    _, ranks = run
    want, _ = unsharded[name]
    for res in ranks:
        for i, (got, w) in enumerate(zip(res[name]["losses"], want)):
            for key in ("loss", "grad_norm", "ce"):
                np.testing.assert_allclose(got[key], w[key], rtol=2e-4,
                                           err_msg=f"{key} step {i + 1}")
            assert got["tokens"] == w["tokens"]


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


# ---------------------------------------------------------------------------
# Adafactor's stored state: the reference's bytes, and where its factors lie
# ---------------------------------------------------------------------------
def _reference_adafactor_bytes(arch, mesh_shape):
    """The reference's ``bytes_per_device`` of its Adafactor state of the
    same reduced model on the same mesh."""
    from repro import configs as rconfigs
    from repro.distrib import sharding as rs
    from repro.models import Model as RModel
    from repro.train import optim as roptim
    from repro.train.step import init_state_axes as r_state_axes
    cfg = rconfigs.reduced(arch).replace(compute_dtype="float32")
    if cfg.moe.num_experts:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=16.0))
        model = RModel(cfg, e_pad=padded_experts(cfg, mesh_shape[1]))
    else:
        model = RModel(cfg)
    values, axes = r_state_axes(model, roptim.OptConfig(name="adafactor"))
    return rs.bytes_per_device(values, axes, rs.abstract_mesh(
        mesh_shape, ("data", "model")))


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if n.startswith("adafactor")))
def test_adafactor_stored_bytes_are_the_references(run, name):
    """Each rank stores ``bytes_per_device`` of ``init_state_axes``'
    Adafactor state, which is the reference's plus exactly the stated
    column copies; every row and column block has its resolved shape."""
    cases, ranks = run
    case = cases[name]
    model = _model(case["arch"], case["mesh"])
    mesh = abstract_mesh(case["mesh"], ("data", "model"))
    shapes, axes = init_state_axes(model, optim.OptConfig(name="adafactor"))
    want = bytes_per_device(shapes, axes, mesh)
    copies = adafactor_column_copies(model, mesh)
    assert copies > 0
    assert want == _reference_adafactor_bytes(case["arch"],
                                              case["mesh"]) + copies
    for res in ranks:
        assert res[name]["stored"]["bytes"] == want
    assert factor_spec_mismatches(model, mesh) == []


def _tp_bytes():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "tp_bytes", Path(__file__).resolve().parents[1] / "tools"
        / "tp_bytes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counts(recs):
    """Calls and bytes by kind, a reduce-scatter's bytes its input's."""
    got = {}
    for rec in recs:
        kind = rec["op"].replace("-", "_")
        row = got.setdefault(kind, {"calls": 0, "bytes": 0})
        row["calls"] += 1
        row["bytes"] += rec["result_bytes"] * (
            rec["group"] if kind == "reduce_scatter" else 1)
    return got


@pytest.mark.parametrize("name", ["adafactor-qwen1.5-2x2",
                                  "adafactor-qwen1.5-1x4",
                                  "adafactor-qwen1.5-4x1",
                                  "micro2-qwen-2x2", "flat-qwen-2x2",
                                  "flat-granite-2x2"])
def test_step_collectives_equal_tp_bytes(run, name):
    """A real step's collectives (rank 0's first step), calls and bytes by
    kind, equal ``tools/tp_bytes.py``'s direct-form reckoning for the
    same optimizer and variant."""
    cases, ranks = run
    case = cases[name]
    variant = ",".join(v for v in (
        "flat_dp" if case.get("flat_dp") else "",
        f"microbatches={case['microbatches']}"
        if case.get("microbatches") else "") if v)
    want = _tp_bytes().reckon(case["arch"], case["mesh"], B, S, "block",
                              reduced=True, variant=variant,
                              opt=case["opt"].get("name", "adamw"))
    assert _counts(ranks[0][name]["collectives"]) == \
        want["calls_a_step"]["direct"]


def test_adafactor_rounds_are_two_a_step(run):
    """Adafactor adds two rounds of all-reduces, one call an axis set a
    round, not one a leaf: on (2, 2) the rows and columns over the data
    and the model axes, then the rows' means over each."""
    cases, ranks = run
    got = _counts(ranks[0]["adafactor-qwen1.5-2x2"]["collectives"])
    base = _tp_bytes().reckon(QWEN, (2, 2), B, S, "block", reduced=True)
    extra = got["all_reduce"]["calls"] - \
        base["calls_a_step"]["direct"]["all_reduce"]["calls"]
    assert extra == 4


def factor_spec_mismatches(model, mesh, rules=None) -> list:
    """The factored leaves whose row or column the resolver places other
    than the leaf's blocks imply: [(leaf index, "row" | "col", the
    resolver's spec, the spec the blocks imply)].  A row must be the
    leaf's spec without its last entry, a column without the entry
    before last."""
    shapes, axes = init_state_axes(model, optim.OptConfig(name="adafactor"))
    pspecs = leaves_of(tree_specs(shapes["params"], axes["params"], mesh,
                                  rules))
    states = optim._states(shapes["params"], shapes["opt"]["f"])
    names = optim._states(shapes["params"], axes["opt"]["f"])

    def strip(spec):
        spec = list(spec)
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)
    out = []
    for i, (p, st, nm, spec) in enumerate(zip(leaves(shapes["params"]),
                                              states, names, pspecs)):
        if "v" in st or p.ndim < 2:
            continue
        full = list(spec) + [None] * (p.ndim - len(spec))
        implied = {"row": strip(full[:-1]),
                   "col": strip(full[:-2] + full[-1:])}
        for key in ("row", "col"):
            got = spec_for(tuple(st[key].shape), nm[key], mesh,
                           merge_rules(DEFAULT_RULES, rules))
            if got != implied[key]:
                out.append((i, key, got, implied[key]))
    return out


MESH_GRID = {(16, 16): ("data", "model"),
             (2, 16, 16): ("pod", "data", "model"),
             (2, 2): ("data", "model"), (1, 4): ("data", "model"),
             (4, 1): ("data", "model")}


@pytest.mark.parametrize("flat", [False, True], ids=["tp", "flat_dp"])
@pytest.mark.parametrize("arch", sorted(configs.names()))
def test_factor_specs_are_the_blocks(arch, flat):
    """For every leaf of ``arch`` (full size) on every mesh of the grid, a
    row's resolved spec is its leaf's without the last entry and a
    column's without the entry before last (the resolver assigns axes
    left to right, so dropping a dimension could free an axis for a
    later one: no leaf of these configs has it)."""
    cfg = configs.get(arch)
    for shape, names in MESH_GRID.items():
        mesh = abstract_mesh(shape, names)
        model = Model(cfg, e_pad=padded_experts(cfg, mesh["model"])
                      if cfg.moe.num_experts else None)
        rules = flat_dp_rules(mesh) if flat else None
        assert factor_spec_mismatches(model, mesh, rules) == [], shape


def test_factor_spec_check_sees_a_freed_axis():
    """The check finds a column whose dropped dimension freed an axis:
    under rules that put ``embed`` and ``mlp`` both on ``model``, an
    (embed, mlp) leaf's column (mlp,) takes the axis its leaf's blocks
    leave whole."""
    model = Model(configs.reduced(QWEN))
    mesh = abstract_mesh((2, 2), ("data", "model"))
    found = factor_spec_mismatches(model, mesh, {"embed": ("model",)})
    assert any(key == "col" for _, key, _, _ in found)


# ---------------------------------------------------------------------------
# param_gather against the reference's cast_params
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def param_gather():
    """The reference's loss and gradients over ``cast_params``'d weights,
    and the port's sharded ones from the same weights (bridged)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import Model as JModel
    from repro.models import unzip
    from repro_torch.models import params_from_numpy
    jcfg = jconfigs.reduced(QWEN).replace(compute_dtype="float32")
    jm = JModel(jcfg)
    jp, _ = unzip(jm.init(jax.random.PRNGKey(0)))
    ported = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    batch = _batches(jcfg.vocab)[0]

    def loss_of(params):
        cast = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32
            else x, params)
        return jm.loss_fn(cast, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, impl="xla", remat="none")
    (jl, jmet), jg = jax.value_and_grad(loss_of, has_aux=True)(jp)
    want = [np.asarray(g) for g in leaves(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jg), device="cpu"))]
    ranks = run_ranks("torch_dist_scenarios", "param_gather_grads", 4,
                      {"arch": QWEN, "remat": "block",
                       "param_gather": "bfloat16", "batch": batch,
                       "params": [t.numpy() for t in leaves(ported)]})
    return float(jl), {k: float(v) for k, v in jmet.items()}, want, ranks


def test_param_gather_loss_and_gradients_match_reference(param_gather):
    jl, jmet, want, ranks = param_gather
    for res in ranks:
        assert abs(res["loss"] - jl) <= GRAD_TOL_BF16 * abs(jl)
        assert res["metrics"]["tokens"] == jmet["tokens"] == B * S
        assert res["dtypes"] == ["torch.float32"]
    got = ranks[0]["grads"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= GRAD_TOL_BF16 * scale, \
            (g.shape, scale)


def test_param_gather_moves_half_the_bytes(param_gather):
    """The 16-bit gathers: every all-gather and reduce-scatter of the step
    (all of them a parameter's or its gradient's in reduced qwen) moves
    half the bytes tools/tp_bytes.py reckons for the f32 step, and the
    whole count equals its ``param_gather`` reckoning."""
    _, _, _, ranks = param_gather
    got = _counts(ranks[0]["collectives"])
    tpb = _tp_bytes()
    base = tpb.reckon(QWEN, (2, 2), B, S, "block", reduced=True)
    half = tpb.reckon(QWEN, (2, 2), B, S, "block", reduced=True,
                      variant="param_gather=bfloat16")
    # the step's own sums (the gradient norm) are not in a gradient pass
    want = half["calls_a_step"]["direct"]
    for kind in ("all_gather", "reduce_scatter"):
        assert got[kind] == want[kind]
        assert 2 * got[kind]["bytes"] == \
            base["calls_a_step"]["direct"][kind]["bytes"]
