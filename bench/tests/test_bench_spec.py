"""``BENCHMARK.json`` against the contract's shape and naming rules; no
module of the benchmark loads JAX or the JAX package, and the reference
loads nothing of the program; a new cell needs only new files."""
import ast
import json
import os
import shutil
import subprocess
import sys

import benchtiny
from benchlib import harness, spec

BENCH, ROOT = benchtiny.BENCH, benchtiny.ROOT
SPEC = spec.load_spec()
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_names_and_units_use_the_allowed_characters():
    assert spec.check_names(SPEC) == []
    assert not spec.check_names(SPEC) and spec.NAME.match("a.b-c_1")
    assert not spec.NAME.match("a b") and not spec.NAME.match("a/b")
    assert not spec.UNIT.match("tokens per second")


def test_spec_has_the_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    for group, keys in ENTRY_KEYS.items():
        for x in SPEC[group]:
            assert set(x) - {"workloads"} == keys, (group, x["name"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for c in m["workloads"]:
            assert m["moves"] in {x["name"] for x in
                                  spec.resolve(c, SPEC).end_to_end}
        assert os.path.exists(spec.metric_file(m["name"]))
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for c in SPEC["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        for key in c["reduced"]:
            assert not key.endswith(("_size", "_dim", "_rank", "_heads",
                                     "_factor", "per_tok")), key
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = spec.resolve(w["name"], SPEC)
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert cell.per_layer


def test_each_configuration_file_states_the_ports_model():
    from benchlib import portcfg
    for c in SPEC["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            portcfg.port_config(json.load(f))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                got = set(_imports(os.path.join(dirpath, f)))
                assert not got & {"jax", "jaxlib", "flax", "repro"}, f
                if os.path.basename(dirpath) == "reference":
                    assert "repro_torch" not in got, f


def test_what_a_run_loads_holds_no_jax():
    """Every module of the harness, every metric's reader and every
    reference, loaded in a fresh process: ``sys.modules`` then holds no
    top-level ``jax``, ``jaxlib``, ``flax`` or ``repro``, and the
    references pull in no ``repro_torch``."""
    code = f"""
import sys, glob, os, importlib
sys.path[:0] = [{BENCH!r}, {os.path.join(ROOT, 'src')!r}]
for p in glob.glob(os.path.join({BENCH!r}, "reference", "*.py")):
    importlib.import_module("reference." + os.path.basename(p)[:-3])
assert not any(k.split(".")[0] == "repro_torch" for k in sys.modules), "ref"
from benchlib import harness, train, check, probes

for p in glob.glob(os.path.join({BENCH!r}, "metrics", "*.py")):
    harness.read_metric(os.path.basename(p)[:-3], type("R", (), {{"spans": {{}}, "counters": {{}}}})())
import repro_torch.services, repro_torch.train.step, repro_torch.models
bad = sorted({{k.split(".")[0] for k in sys.modules}} & {{"jax", "jaxlib", "flax", "repro"}})
print(bad)
"""
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as
    files of their own, and one cell added to ``workloads``: the harness
    finds them by name and runs the cell, with no existing file edited."""
    root = tmp_path / "checkout"
    (root / "bench").mkdir(parents=True)
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), root / "bench" / d)
    base = SPEC["workloads"][0]
    cfg = benchtiny.tiny_config(base["config"])
    cfg["name"] = "tiny-dense"
    (root / "bench" / "configs" / "tiny-dense.json").write_text(
        json.dumps(cfg))
    mix = benchtiny.tiny_mix(base["traffic"])
    (root / "bench" / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    (root / "bench" / "metrics" / "tiny.plain_s.py").write_text(
        "def read(run):\n    return run.counters.get('model.step_s')\n")
    new = dict(SPEC)
    new["configs"] = SPEC["configs"] + [
        {"name": "tiny-dense", "source": "https://example.org",
         "file": "bench/configs/tiny-dense.json", "reduced": [],
         "why": "a test"}]
    new["workloads"] = SPEC["workloads"] + [
        {"name": "tiny-dense.tiny_mix", "config": "tiny-dense",
         "traffic": "tiny_mix", "chips": 1, "why": "a test"}]
    new["end_to_end"] = [
        dict(m, workloads=m["workloads"] + ["tiny-dense.tiny_mix"])
        if "workloads" in m else m for m in SPEC["end_to_end"]]
    new["per_layer"] = SPEC["per_layer"] + [
        {"name": "tiny.plain_s", "unit": "s", "better": "lower",
         "source": "program_counter", "layer": "trainer",
         "moves": "train_tok_per_s", "workloads": ["tiny-dense.tiny_mix"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    assert spec.check_names(new) == []
    cell = spec.resolve("tiny-dense.tiny_mix", new, root)
    assert [m["name"] for m in cell.per_layer] == ["tiny.plain_s"]
    assert {m["name"] for m in cell.end_to_end} == {"train_tok_per_s",
                                                    "setup_s"}
    assert cell.traffic == mix and cell.config == cfg
    cell.entry["limits"] = benchtiny.tiny_limits(cell.name, cfg)
    run = benchtiny.run_tiny(cell, seconds=1.0, trace=True)
    assert run.correct and run.e2e["train_tok_per_s"] > 0
    value = harness.read_metric("tiny.plain_s", run,
                                root / "bench" / "metrics")
    assert value and value > 0
