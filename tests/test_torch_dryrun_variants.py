"""The dry run's hillclimb variants (``--variant``, the reference's
``lower_cell(overrides=)``): their collectives, analytic bytes and
records.

* Each variant's train cell (reduced qwen1.5-0.5b: ``param_gather``,
  ``flat_dp``, ``microbatches=2``, ``gather_once`` and the three
  comma-joined; reduced granite-moe-3b-a800m: ``flat_dp`` and
  ``moe_dispatch=cumsum``) and ``flat_dp``'s serving cells traced in a
  (2, 2) fake world (a subprocess) record, call for call, the
  collectives a real run of the same cell issues as 4 gloo ranks on the
  CPU; their counts by kind are ``tools/tp_bytes.py``'s where it
  reckons the cell (every train cell but expert-parallel granite).
* Against the base cell: ``param_gather`` moves exactly half the bytes
  of every all-gather and reduce-scatter (each a parameter's or its
  gradient's), ``gather_once`` the same collectives, ``flat_dp`` none
  over the model axis alone (every group spans all 4 ranks).
* ``flat_dp``'s ``state_bytes_analytic`` / ``cache_bytes_analytic`` of
  all 33 cells on both production meshes equal the reference's
  ``bytes_per_device`` under its flat rules (the reference in a
  subprocess: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``).
* The command line: ``--variant`` parsed as the reference parses it, a
  record's ``variant`` and ``overrides`` keys and its file's suffix.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
QWEN, GRANITE = "qwen1.5-0.5b", "granite-moe-3b-a800m"
ALL_THREE = "param_gather=bfloat16,flat_dp,microbatches=2"
# name -> (arch, kind, global batch, sequence, variant), at reduced size
CELLS = {"qwen-train": (QWEN, "train", 8, 16, ""),
         "qwen-train__pg": (QWEN, "train", 8, 16, "param_gather=bfloat16"),
         "qwen-train__flat": (QWEN, "train", 8, 16, "flat_dp"),
         "qwen-train__micro2": (QWEN, "train", 8, 16, "microbatches=2"),
         "qwen-train__once": (QWEN, "train", 8, 16, "gather_once"),
         "qwen-train__all3": (QWEN, "train", 8, 16, ALL_THREE),
         "qwen-prefill__flat": (QWEN, "prefill", 4, 16, "flat_dp"),
         "qwen-decode__flat": (QWEN, "decode", 4, 32, "flat_dp"),
         "granite-train__flat": (GRANITE, "train", 8, 16, "flat_dp"),
         "granite-train__cumsum": (GRANITE, "train", 8, 16,
                                   "moe_dispatch=cumsum"),
         "granite-prefill__flat": (GRANITE, "prefill", 4, 16, "flat_dp")}
MESH_KINDS = ("single", "multi")
FLAT_CELLS = [(a, s, m) for a, s in configs.all_cells() for m in MESH_KINDS]

_FAKE_WORLD = """
import json, sys
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.distrib import collectives as coll
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
cells = json.loads(sys.argv[1])
dryrun.fake_world(4)
mesh = Mesh((2, 2), ("data", "model"), backend="fake")
out = {}
for name, (arch, kind, batch, seq, variant) in cells.items():
    shape = ShapeSpec(name=name, kind=kind, seq_len=seq, global_batch=batch)
    with FakeTensorMode():
        run, _, _ = dryrun.lower_cell(
            arch, shape, mesh, cfg=configs.reduced(arch),
            overrides=dryrun.parse_variant(variant))
        with coll.record() as recs:
            run()
    out[name] = list(recs)
print("DRY " + json.dumps(out))
"""

_REFERENCE_FLAT = """
import json
from repro.launch import dryrun as d
from repro import configs
from repro.configs.base import SHAPES
from repro.distrib.sharding import bytes_per_device
from repro.launch.mesh import dp_axes, make_production_mesh
from repro.models import Model
from repro.models.moe import padded_experts
out, trees = {}, {}
meshes = {"single": make_production_mesh(multi_pod=False),
          "multi": make_production_mesh(multi_pod=True)}
for arch, shape in configs.all_cells():
    cfg, spec = configs.get(arch), SHAPES[shape]
    e_pad = padded_experts(cfg, 16) if cfg.moe.num_experts else None
    model = Model(cfg, e_pad=e_pad)
    key = (arch, spec.kind == "train")
    if key not in trees:
        trees[key] = (d.abstract_state(model, d.opt_for(cfg))
                      if spec.kind == "train" else d.abstract_params(model))
    cache = (d.abstract_cache(model, spec.global_batch, spec.seq_len)
             if spec.kind == "decode" else None)
    for mk, mesh in meshes.items():
        # lower_cell's flat_dp rules, verbatim
        rules = d.cell_rules(spec)
        dp_all = tuple(dp_axes(mesh)) + ("model",)
        rules.update({"heads": (), "kv_heads": (), "mlp": (), "vocab": (),
                      "experts": (), "inner": (), "lru": (),
                      "ssm_heads": (), "embed": dp_all, "batch": dp_all})
        rec = {"state": bytes_per_device(*trees[key], mesh, rules)}
        if cache is not None:
            rec["cache"] = bytes_per_device(*cache, mesh, rules)
        out[f"{arch}|{shape}|{mk}"] = rec
print("REF " + json.dumps(out))
"""

_CLI = """
import sys
from repro_torch.launch import dryrun
dryrun.main(sys.argv[1:])
"""


def _start(argv, cwd=None):
    return subprocess.Popen(
        [sys.executable] + argv, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(ROOT / "src")})


def _line(proc, tag, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    line = [x for x in out.splitlines() if x.startswith(tag + " ")][-1]
    return json.loads(line[len(tag) + 1:])


@pytest.fixture(scope="module")
def runs():
    """The fake world's traces, the reference's flat bytes, one variant
    cell through the command line and the real 4-rank run, started at
    once."""
    tmp = tempfile.TemporaryDirectory(prefix="dryrun-variants-")
    fake = _start(["-c", _FAKE_WORLD, json.dumps(CELLS)])
    ref = _start(["-c", _REFERENCE_FLAT])
    cli = _start(["-c", _CLI, "--arch", QWEN, "--shape", "decode_32k",
                  "--no-cost", "--variant", "flat_dp,microbatches=2"],
                 cwd=tmp.name)
    real = run_ranks("torch_dist_scenarios", "dry_collectives", 4,
                     {k: tuple(v) for k, v in CELLS.items()})
    out = {"real": real[0], "fake": _line(fake, "DRY"),
           "ref": _line(ref, "REF")}
    _, err = cli.communicate(timeout=300)
    assert cli.returncode == 0, err[-3000:]
    folder = Path(tmp.name) / "experiments" / "dryrun_torch"
    out["cli"] = {p.name: json.loads(p.read_text())
                  for p in folder.glob("*.json")}
    tmp.cleanup()
    return out


@pytest.mark.parametrize("name", sorted(CELLS))
def test_variant_collectives_equal_a_real_runs(runs, name):
    fake, real = runs["fake"][name], runs["real"][name]
    assert len(fake) > 0
    assert fake == real


def _counts(recs):
    got = {}
    for rec in recs:
        kind = rec["op"].replace("-", "_")
        row = got.setdefault(kind, {"calls": 0, "bytes": 0})
        row["calls"] += 1
        row["bytes"] += rec["result_bytes"] * (
            rec["group"] if kind == "reduce_scatter" else 1)
    return got


def _tp_bytes():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "tp_bytes", ROOT / "tools" / "tp_bytes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(
    n for n, c in CELLS.items() if c[1] == "train"
    and n != "granite-train__cumsum"))
def test_variant_train_counts_equal_tp_bytes(runs, name):
    arch, _, batch, seq, variant = CELLS[name]
    want = _tp_bytes().reckon(arch, (2, 2), batch, seq, "block",
                              reduced=True, variant=variant)
    assert _counts(runs["fake"][name]) == want["calls_a_step"]["direct"]


def test_tp_bytes_refuses_expert_parallel_moe():
    with pytest.raises(SystemExit):
        _tp_bytes().reckon(GRANITE, (2, 2), 8, 16, "block", reduced=True,
                           variant="moe_dispatch=cumsum")


def test_param_gather_halves_the_gathers(runs):
    base = _counts(runs["fake"]["qwen-train"])
    half = _counts(runs["fake"]["qwen-train__pg"])
    for kind in ("all_gather", "reduce_scatter"):
        assert half[kind]["calls"] == base[kind]["calls"]
        assert 2 * half[kind]["bytes"] == base[kind]["bytes"]


def test_gather_once_traces_the_base_cells_collectives(runs):
    assert runs["fake"]["qwen-train__once"] == runs["fake"]["qwen-train"]


@pytest.mark.parametrize("name", sorted(n for n in CELLS
                                        if "flat" in n or "all3" in n))
def test_flat_dp_runs_nothing_over_the_model_axis_alone(runs, name):
    """Every collective of a ``flat_dp`` cell spans all four ranks (the
    base train cell has groups of the model axis alone: ranks 0 and 1)."""
    groups = {(r["group"], r["span"]) for r in runs["fake"][name]}
    assert groups == {(4, 4)}
    assert (2, 2) in {(r["group"], r["span"])
                      for r in runs["fake"]["qwen-train"]}


@pytest.mark.parametrize("arch,shape,mesh_kind", FLAT_CELLS)
def test_flat_dp_analytic_bytes_equal_the_reference(runs, arch, shape,
                                                    mesh_kind):
    dims, axes = dryrun.MESHES[mesh_kind]
    mesh = SimpleNamespace(shape=dict(zip(axes, dims)))
    got = dryrun.analytic(dryrun.model_for(arch, mesh), SHAPES[shape],
                          mesh, {"flat_dp": True})
    want = runs["ref"][f"{arch}|{shape}|{mesh_kind}"]
    assert got["state_bytes_analytic"] == want["state"]
    assert got.get("cache_bytes_analytic") == want.get("cache")


def test_variant_record_name_and_keys(runs):
    name = f"{QWEN}_decode_32k_single__flat_dp+microbatches-2.json"
    assert list(runs["cli"]) == [name]
    rec = runs["cli"][name]
    assert rec["ok"] and rec["variant"] == "flat_dp+microbatches-2"
    assert rec["overrides"] == {"flat_dp": "True", "microbatches": "2"}
    # 128 rows do not split over 256 ranks: over the data axis's 16, as
    # the cache's batch dimension resolves under the flat rules
    assert rec["batch_axes"] == ["data"]


@pytest.mark.parametrize("text,want", [
    ("", {}), ("flat_dp", {"flat_dp": True}),
    ("param_gather=bfloat16", {"param_gather": "bfloat16"}),
    ("moe_dispatch=cumsum,gather_once,microbatches=4",
     {"moe_dispatch": "cumsum", "gather_once": True, "microbatches": "4"})])
def test_variant_parses_as_the_reference(text, want):
    assert dryrun.parse_variant(text) == want
    assert dryrun.variant_name(text) == \
        text.replace(",", "+").replace("=", "-")


def test_unknown_override_is_refused():
    with pytest.raises(ValueError, match="unknown overrides"):
        dryrun.lower_cell(QWEN, "train_4k", {"data": 1, "model": 1},
                          overrides={"fused": True})
