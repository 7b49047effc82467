"""Sequence parallelism in the sharded training step
(``make_train_step(..., mesh=, seq_parallel=True)``,
``distrib.tensor_parallel``), its rule against the reference's, and
``tools/tp_bytes.py``'s collectives against a run's.

One run a module: 4 gloo ranks on the CPU (``torch_ranks``, 120 s limit)
on meshes (data 2, model 2) and (data 1, model 4):

* 3 AdamW steps with sequence parallelism forced on reduced
  qwen1.5-0.5b, recurrentgemma-9b (RG-LRU blocks and MQA local
  attention), gemma3-12b (qk-norm, local and global layers) and
  command-r-35b (a parallel block: one entry and one exit a layer), and
  qwen with a vocabulary of 509 that the model axis does not divide (the
  whole-vocabulary lookup of this rank's positions), f32, remat
  "block", against the unsharded step at ``test_torch_sharded_step.py``'s
  bounds (loss and gradient norm rtol 2e-4, every parameter after 1 and
  3 steps within 1e-5);
* each block's residual-stream input on a rank, in the forward and in
  the recompute: S/n positions;
* each collective of one step, by kind (calls and bytes), equal to what
  ``tools/tp_bytes.py`` reckons from the code, for reduced mamba2-1.3b
  in tensor parallel and reduced recurrentgemma-9b sequence-parallel.

Without ranks: what refuses sequence parallelism (experts, a frontend,
an encoder, a sequence the model axis does not divide, no mesh), and
the port's ``seq_parallel_for`` against the reference's
``act_sharding_for`` for every config, shape and mesh, the reference run
in a subprocess (importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``).
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES, ParallelConfig  # noqa: E402
from repro_torch.distrib.sharding import abstract_mesh  # noqa: E402
from repro_torch.distrib.tensor_parallel import (  # noqa: E402
    TensorParallel, seq_parallel_for)
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.moe import padded_experts  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.optim import leaves  # noqa: E402
from repro_torch.train.step import init_state, make_train_step  # noqa: E402
from torch_dist_scenarios import _step_model  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = ((2, 2), (1, 4))
AXES = ("data", "model")
ARCHS = ("qwen1.5-0.5b", "recurrentgemma-9b", "gemma3-12b",
         "command-r-35b")
STEPS = {f"{a.split('-')[0]}-{m[0]}x{m[1]}": (a, m, {}) for a in ARCHS
         for m in MESHES}
STEPS["qwen-v509-2x2"] = ("qwen1.5-0.5b", (2, 2), dict(vocab=509))
OPT = dict(lr=1e-3, warmup=0, decay_steps=10, eps=1e-3)
N_STEPS, SNAPS = 3, (1, 3)
B, S = 8, 16
SHARD = {"recurrentgemma-2x2": ("recurrentgemma-9b", (2, 2)),
         "command-1x4": ("command-r-35b", (1, 4))}
# (arch, mesh, sequence-parallel): the runs tools/tp_bytes.py reckons
COUNTS = {"mamba2-tp": ("mamba2-1.3b", (2, 2), False),
          "recurrentgemma-sp": ("recurrentgemma-9b", (2, 2), True)}
RULE_MESHES = ((2, 2), (1, 4), (4, 1), (16, 16), (2, 16, 16))


def _batches(vocab, seed=0, n=N_STEPS):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


def _args():
    steps = {}
    for name, (arch, mesh, over) in STEPS.items():
        cfg = configs.reduced(arch).replace(**over)
        steps[name] = dict(arch=arch, mesh=mesh, over=over, opt=OPT,
                           remat="block", snap=SNAPS, seq_parallel=True,
                           batches=_batches(cfg.vocab))
    shard = {name: dict(arch=arch, mesh=mesh,
                        batch=_batches(configs.reduced(arch).vocab, 4, 1)[0])
             for name, (arch, mesh) in SHARD.items()}
    counts = {name: dict(arch=arch, mesh=mesh, seq_parallel=sp,
                         remat="block",
                         batch=_batches(configs.reduced(arch).vocab, 5, 1)[0])
              for name, (arch, mesh, sp) in COUNTS.items()}
    return dict(meshes=MESHES, steps=steps, shard=shard, counts=counts)


@pytest.fixture(scope="module")
def run():
    args = _args()
    return args, run_ranks("torch_dist_scenarios", "seq_parallel", 4, args)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def unsharded(run):
    args, _ = run
    out = {}
    for name, case in args["steps"].items():
        model = _step_model(case["arch"], case["mesh"], case["over"])
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


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_loss_matches_unsharded(run, unsharded, name):
    _, ranks = run
    want, _ = unsharded[name]
    for res in ranks:
        for i, (got, w) in enumerate(zip(res["steps"][name]["losses"],
                                         want)):
            np.testing.assert_allclose(got["loss"], w["loss"], rtol=2e-4,
                                       err_msg=f"step {i + 1}")
            np.testing.assert_allclose(got["grad_norm"], w["grad_norm"],
                                       rtol=2e-4, err_msg=f"step {i + 1}")
            assert got["tokens"] == B * S


@pytest.mark.parametrize("step", SNAPS)
@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_params_match_unsharded(run, unsharded, name, step):
    _, ranks = run
    _, want = unsharded[name]
    got = ranks[0]["steps"][name]["snaps"][step]
    assert len(got) == len(want[step])
    worst = max(float(np.abs(g - w).max()) for g, w in
                zip(got, want[step]))
    assert worst <= 1e-5, worst


# ---------------------------------------------------------------------------
# the stream's shard
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(SHARD))
def test_each_layer_input_is_the_ranks_positions(run, name):
    args, ranks = run
    _, mesh = SHARD[name]
    rows, n = B // mesh[0], mesh[1]
    for res in ranks:
        got = res["shard"][name]
        # the forward, then the recompute of every layer (remat "block")
        assert len(got["inputs"]) == 2 * got["layers"]
        assert {shape[:2] for shape in got["inputs"]} == {(rows, S // n)}


# ---------------------------------------------------------------------------
# the collectives, against tools/tp_bytes.py
# ---------------------------------------------------------------------------
def _tp_bytes():
    spec = importlib.util.spec_from_file_location(
        "tp_bytes", ROOT / "tools" / "tp_bytes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_tp_bytes_counts_what_a_step_issues(run, name):
    _, ranks = run
    arch, mesh, sp = COUNTS[name]
    want = _tp_bytes().reckon(arch, mesh, B, S, "block", reduced=True,
                              seq_parallel=sp)["calls_a_step"]["direct"]
    for res in ranks:
        got = res["counts"][name]
        # the kinds under the names of this torch
        got = {_kind(k): v for k, v in got.items()}
        assert got == want


def _kind(name):
    return ("all_gather" if name.startswith("all_gather")
            else "reduce_scatter" if name.startswith("reduce_scatter")
            else name)


# ---------------------------------------------------------------------------
# what refuses sequence parallelism
# ---------------------------------------------------------------------------
def _fake_mesh(data=2, model=2):
    return SimpleNamespace(shape={"data": data, "model": model},
                           coords={"data": 0, "model": 0})


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b",
                                  "paligemma-3b", "seamless-m4t-large-v2"])
def test_experts_frontends_and_encoders_refuse(arch):
    cfg = configs.reduced(arch)
    model = (Model(cfg, e_pad=padded_experts(cfg, 2))
             if cfg.moe.num_experts else Model(cfg))
    with pytest.raises(ValueError, match="sequence parallelism"):
        TensorParallel(model, _fake_mesh(), ("data",), "model",
                       seq_parallel=True)
    # without it the layout builds
    TensorParallel(model, _fake_mesh(), ("data",), "model")


@pytest.mark.parametrize("model_axis", [2, 4])
def test_a_sequence_the_model_axis_does_not_divide_refuses(model_axis):
    model = Model(configs.reduced("qwen1.5-0.5b"))
    tp = TensorParallel(model, _fake_mesh(1, model_axis), ("data",),
                        "model", seq_parallel=True)
    batch = {"tokens": torch.zeros((2, 4 * model_axis + 1), dtype=torch.long)}
    batch["targets"] = batch["tokens"]
    with pytest.raises(ValueError, match="do not split"):
        model.loss_fn(model.init(device="meta"), batch, spmd=tp)


def test_sequence_parallelism_needs_a_mesh():
    model = Model(configs.reduced("qwen1.5-0.5b"))
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(model, optim.OptConfig(), ParallelConfig(),
                        seq_parallel=True)


def test_one_rank_model_axis_keeps_the_stream_whole():
    model = Model(configs.reduced("gemma3-12b"))
    tp = TensorParallel(model, _fake_mesh(4, 1), ("data",), "model",
                        seq_parallel=True)
    assert tp.stream is None
    tp = TensorParallel(model, _fake_mesh(2, 2), ("data",), "model",
                        seq_parallel=True)
    assert tp.stream is not None and tp.stream.seq
    assert tp.split(("layers", 0, "attn")).seq


# ---------------------------------------------------------------------------
# the rule, against the reference's act_sharding_for
# ---------------------------------------------------------------------------
_REFERENCE_RULE = """
import json, sys
import numpy as np
from repro.launch import dryrun
import jax
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import SHAPES
out = {}
for shape in json.loads(sys.argv[1]):
    axes = ("pod", "data", "model")[-len(shape):]
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    for arch in configs.names():
        cfg = configs.get(arch)
        for sname, spec in SHAPES.items():
            got = dryrun.act_sharding_for(cfg, mesh, spec)
            out[f"{arch}|{sname}|{shape}"] = (
                got is not None and got.spec[1] == "model")
print("RULE " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_rule():
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE_RULE,
         json.dumps([list(m) for m in RULE_MESHES])],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr[-3000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("RULE ")][-1]
    return json.loads(line[5:])


@pytest.mark.parametrize("mesh", RULE_MESHES,
                         ids=lambda m: "x".join(map(str, m)))
def test_rule_is_the_references(reference_rule, mesh):
    axes = ("pod", "data", "model")[-len(mesh):]
    abstract = abstract_mesh(mesh, axes)
    chosen = []
    for arch in configs.names():
        cfg = configs.get(arch)
        for sname, spec in SHAPES.items():
            got = seq_parallel_for(cfg, abstract, spec.global_batch,
                                   spec.seq_len, spec.kind)
            assert got == reference_rule[f"{arch}|{sname}|{list(mesh)}"], \
                (arch, sname)
            if got:
                chosen.append(arch)
    # the four wide dense configs, training
    assert sorted(set(chosen)) == ["command-r-35b", "gemma3-12b",
                                   "nemotron-4-340b", "recurrentgemma-9b"]
