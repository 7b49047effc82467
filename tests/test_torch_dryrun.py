"""The dry run (``repro_torch.launch.dryrun``): each cell traced as rank
0 of a fake world, its reckonings against the reference's and a real
run's.

* ``state_bytes_analytic`` / ``cache_bytes_analytic`` of every cell
  (33 (arch, shape) pairs) on both production meshes equal the
  reference's ``bytes_per_device`` over ``jax.eval_shape``'d state and
  cache under its ``cell_rules`` and ``opt_for`` (the reference runs in
  a subprocess: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``).
* The collectives a dry run records at a (2, 2) fake world (a
  subprocess) for reduced qwen1.5-0.5b (train, prefill, decode) and
  reduced granite-moe-3b-a800m (train) equal, call for call (op, result
  bytes, group, span), a real run of the same cells as 4 gloo ranks on
  the CPU; the train cell's counts by kind equal
  ``tools/tp_bytes.py``'s direct-form reckoning.
* The 2-point fit ``a + b·n_periods`` reproduces a 3-period trace
  exactly (FLOPs, bytes, wire bytes).
* Each kernel wrapper's shape path (fake tensors) gives its plain
  version's shapes and dtypes, adds its call to the tally and launches
  nothing.
* Two full-size cells through the command line, qwen1.5-0.5b
  ``train_4k`` and mamba2-1.3b ``decode_32k``: ``ok``, and the process
  never held a parameter-sized tensor (its peak resident memory is
  under the model's f32 parameters).
* The bounds ``chip_smoke.py`` prints, now ``kernels/cost.py``'s, give
  the numbers the script's own formulas gave before the move; the
  pair count from shapes equals the mask's.
"""
import importlib.util
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
from repro_torch.kernels import cost  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESH_KINDS = ("single", "multi")
CELLS = [(a, s, m) for a, s in configs.all_cells() for m in MESH_KINDS]
# name -> (arch, kind, global batch, sequence), at reduced size
COLL_CELLS = {"qwen-train": ("qwen1.5-0.5b", "train", 8, 16),
              "qwen-prefill": ("qwen1.5-0.5b", "prefill", 4, 16),
              "qwen-decode": ("qwen1.5-0.5b", "decode", 4, 32),
              "granite-train": ("granite-moe-3b-a800m", "train", 8, 16)}
FIT_CELLS = {"qwen-train": ("qwen1.5-0.5b", "train", 8, 16),
             "recurrentgemma-prefill": ("recurrentgemma-9b", "prefill", 4,
                                        16)}
FULL_CELLS = (("qwen1.5-0.5b", "train_4k"), ("mamba2-1.3b", "decode_32k"))

_REFERENCE_BYTES = """
import json
from repro.launch import dryrun as d
from repro import configs
from repro.configs.base import SHAPES
from repro.distrib.sharding import bytes_per_device
from repro.launch.mesh import make_production_mesh
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
        rules = d.cell_rules(spec)
        rec = {"state": bytes_per_device(*trees[key], mesh, rules)}
        if cache is not None:
            rec["cache"] = bytes_per_device(*cache, mesh, rules)
        out[f"{arch}|{shape}|{mk}"] = rec
print("REF " + json.dumps(out))
"""

_FAKE_WORLD = """
import json, sys
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.distrib import collectives as coll
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
args = json.loads(sys.argv[1])
dryrun.fake_world(4)
mesh = Mesh((2, 2), ("data", "model"), backend="fake")
out = {"colls": {}, "fit": {}}
for name, (arch, kind, batch, seq) in args["colls"].items():
    shape = ShapeSpec(name=name, kind=kind, seq_len=seq, global_batch=batch)
    with FakeTensorMode():
        run, _, _ = dryrun.lower_cell(arch, shape, mesh,
                                      cfg=configs.reduced(arch))
        with coll.record() as recs:
            run()
    out["colls"][name] = list(recs)
for name, (arch, kind, batch, seq) in args["fit"].items():
    shape = ShapeSpec(name=name, kind=kind, seq_len=seq, global_batch=batch)
    pts = {}
    for k in (1, 2, 3):
        flops, nbytes, recs, _ = dryrun.trace_cost(
            arch, shape, mesh, k, cfg=configs.reduced(arch))
        pts[k] = [flops, nbytes, sum(dryrun.wire_bytes(r) for r in recs)]
    out["fit"][name] = pts
print("DRY " + json.dumps(out))
"""


def _start(argv, cwd=None, env=None):
    return subprocess.Popen(
        [sys.executable] + argv, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(ROOT / "src"), **(env or {})})


def _line(proc, tag, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    line = [x for x in out.splitlines() if x.startswith(tag + " ")][-1]
    return json.loads(line[len(tag) + 1:])


_FULL = """
import resource, sys
from repro_torch.launch import dryrun
dryrun.main(sys.argv[1:])
print("MAXRSS", resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
"""


@pytest.fixture(scope="module")
def runs():
    """Every process of the module, started at once: the reference's
    bytes, the fake world's traces, the two full-size cells and the
    real 4-rank run of the collective cells."""
    tmp = tempfile.TemporaryDirectory(prefix="dryrun-")
    ref = _start(["-c", _REFERENCE_BYTES])
    fake = _start(["-c", _FAKE_WORLD, json.dumps(
        {"colls": COLL_CELLS, "fit": FIT_CELLS})])
    full = {cell: _start(["-c", _FULL, "--arch", cell[0], "--shape",
                          cell[1]], cwd=tmp.name) for cell in FULL_CELLS}
    real = run_ranks("torch_dist_scenarios", "dry_collectives", 4,
                     COLL_CELLS)
    out = {"real": real[0], "ref": _line(ref, "REF"),
           "fake": _line(fake, "DRY"), "full": {}}
    for (arch, shape), proc in full.items():
        rss_kb = _line(proc, "MAXRSS")
        rec = json.loads((Path(tmp.name) / "experiments" / "dryrun_torch"
                          / f"{arch}_{shape}_single.json").read_text())
        out["full"][(arch, shape)] = (rec, rss_kb)
    tmp.cleanup()
    return out


# ---------------------------------------------------------------------------
# analytic bytes, against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape,mesh_kind", CELLS)
def test_analytic_bytes_equal_the_reference(runs, arch, shape, mesh_kind):
    dims, axes = dryrun.MESHES[mesh_kind]
    mesh = SimpleNamespace(shape=dict(zip(axes, dims)))
    got = dryrun.analytic(dryrun.model_for(arch, mesh), SHAPES[shape], mesh)
    want = runs["ref"][f"{arch}|{shape}|{mesh_kind}"]
    assert got["state_bytes_analytic"] == want["state"]
    assert got.get("cache_bytes_analytic") == want.get("cache")


# ---------------------------------------------------------------------------
# the collectives: fake world against a real run, and tools/tp_bytes.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(COLL_CELLS))
def test_dry_run_collectives_equal_a_real_runs(runs, name):
    fake, real = runs["fake"]["colls"][name], runs["real"][name]
    assert len(fake) > 0
    assert fake == real


def _tp_bytes():
    spec = importlib.util.spec_from_file_location(
        "tp_bytes", ROOT / "tools" / "tp_bytes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_counts_equal_tp_bytes(runs):
    """The direct form's calls and bytes by kind (a call's larger buffer:
    a reduce-scatter's input, the group times its result)."""
    arch, _, batch, seq = COLL_CELLS["qwen-train"]
    want = _tp_bytes().reckon(arch, (2, 2), batch, seq, "block",
                              reduced=True)["calls_a_step"]["direct"]
    got = {}
    for rec in runs["fake"]["colls"]["qwen-train"]:
        kind = rec["op"].replace("-", "_")
        row = got.setdefault(kind, {"calls": 0, "bytes": 0})
        row["calls"] += 1
        row["bytes"] += rec["result_bytes"] * (
            rec["group"] if kind == "reduce_scatter" else 1)
    assert got == want


@pytest.mark.parametrize("name", sorted(FIT_CELLS))
def test_two_point_fit_reproduces_three_periods(runs, name):
    pts = runs["fake"]["fit"][name]
    for i, what in enumerate(("flops", "bytes", "wire")):
        f1, f2, f3 = (pts[str(k)][i] for k in (1, 2, 3))
        b = f2 - f1
        assert f1 - b + 3 * b == pytest.approx(f3, rel=1e-12, abs=1e-6), \
            what
        assert b > 0, what


# ---------------------------------------------------------------------------
# the kernels' shape paths
# ---------------------------------------------------------------------------
def _kernel_calls():
    """name -> (wrapper call on inputs, inputs): small shapes of one
    chunk (the backward wrappers then need no kept states)."""
    from repro_torch.kernels import attention as fa
    from repro_torch.kernels import cross_entropy as kce
    from repro_torch.kernels import moe_combine as kc
    from repro_torch.kernels import moe_router as kr
    from repro_torch.kernels import rglru as kg
    from repro_torch.kernels import ssd as ks
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)
    B, S, H, D = 2, 8, 4, 16
    q, k, v = r(B, S, H, D), r(B, S, 2, D), r(B, S, 2, D)
    o, lse = fa.attention_fwd_plain(q, k, v)
    T, E, K, C = 8, 4, 2, 8
    logits = r(T, E)
    rt = kr.router_dispatch_plain(logits, K, n_real=E, capacity=C)
    out_buf = r(E * C, 16)
    x, dt = r(B, S, H, 8), torch.rand(B, S, H, generator=g) * 0.1
    A, Bm, Cm, Dv = -torch.rand(H, generator=g), r(B, S, 1, 4), \
        r(B, S, 1, 4), torch.ones(H)
    xr, rg, ig, ll = r(B, S, 8), r(B, S, 8), r(B, S, 8), r(8)
    tgt = torch.randint(-1, 37, (16,), generator=g)
    return {
        "cross_entropy": (lambda *a: kce.cross_entropy(*a, z_coef=1e-4,
                                                       grad=True),
                          (r(16, 37), tgt, torch.tensor(12))),
        "attention": (lambda *a: fa.attention(*a), (q, k, v)),
        "attention_fwd": (lambda *a: fa.attention_fwd(*a), (q, k, v)),
        "attention_bwd": (lambda *a: fa.attention_bwd(*a),
                          (q, k, v, o, lse, r(B, S, H, D))),
        "router_dispatch": (lambda lg: kr.router_dispatch(
            lg, K, n_real=E, capacity=C), (logits,)),
        "moe_combine": (kc.moe_combine, (out_buf, rt.w, rt.slot)),
        "moe_combine_bwd": (lambda *a: kc.moe_combine_bwd(*a, n_real=E),
                            (r(T, 16), out_buf, logits, rt.probs, rt.idx,
                             rt.w, rt.slot, rt.src, r(E), r(1)[0])),
        "ssd": (lambda *a: ks.ssd(*a), (x, dt, A, Bm, Cm, Dv)),
        "ssd_bwd": (lambda *a: ks.ssd_bwd(*a, None),
                    (x, dt, A, Bm, Cm, Dv, None, r(*x.shape))),
        "rglru": (lambda *a: kg.rglru(*a), (xr, rg, ig, ll)),
        "rglru_bwd": (lambda *a: kg.rglru_bwd(*a, None),
                      (xr, rg, ig, ll, None, r(*xr.shape))),
    }


def _meta(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.dtype)
    if out is None:
        return None
    return [_meta(t) for t in out]


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_shape_path_gives_the_plain_shapes(name):
    from torch._subclasses.fake_tensor import FakeTensorMode
    fn, args = _kernel_calls()[name]
    want = _meta(fn(*args))
    with FakeTensorMode() as mode:
        fake = [None if a is None else mode.from_tensor(a) for a in args]
        with cost.tallying() as tally:
            got = _meta(fn(*fake))
    assert got == want
    assert sum(tally.calls.values()) == 1
    assert tally.nbytes > 0 and tally.ops > 0


def test_visible_pairs_count_the_mask():
    """The pair count the dry run reckons from shapes equals the mask's
    (``chip_smoke.py``'s bounds read the same count)."""
    cases = [(8, 8, [0, 0], True, 0, None), (4, 32, [28, 3], True, 0, None),
             (16, 16, [0], True, 5, None), (6, 20, [0, 14], True, 0, 9),
             (1, 64, [63, -1, 70], True, 16, None),
             (8, 24, [0], False, 0, None)]
    for S, T, offs, causal, window, prefix in cases:
        want = int(cost.visible(S, T, offs, causal, window, prefix).sum())
        assert cost.visible_pairs(S, T, offs, causal, window,
                                  prefix) == want


# ---------------------------------------------------------------------------
# full-size cells through the command line
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", FULL_CELLS)
def test_full_size_cell_traces_without_allocating(runs, arch, shape):
    rec, rss_kb = runs["full"][(arch, shape)]
    assert rec["ok"] and rec["rank"] == 0
    assert rec["n_layers"] == configs.get(arch).n_layers
    assert 0 < rec["memory"]["peak_bytes"] <= rec["memory"]["hbm_bytes"]
    for key in ("t_compute", "t_memory", "t_collective"):
        assert rec[key] > 0
    params = configs.get(arch).param_count() * 4
    assert rss_kb * 1024 < params, (rss_kb, params)


# ---------------------------------------------------------------------------
# the bounds chip_smoke.py prints, moved into kernels/cost.py
# ---------------------------------------------------------------------------
def _old_bound_of(nbytes, ops, dtype, peak=None):
    """chip_smoke.py's ``bound_of`` before the move, verbatim."""
    t_bytes = nbytes / 3.35e12
    t_ops = ops / ({torch.bfloat16: 989e12, torch.float32: 67e12}[dtype]
                   if peak is None else peak)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _old_attention(q, k, offsets, causal, window, prefix):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    elt = q.element_size()
    kv_rows = 0
    for off in offsets:
        last = T if not causal else min(T, max(off + S, prefix or 0))
        first = max(0, off - window + 1) if window > 0 else 0
        kv_rows += max(last - first, 0)
    nbytes = 2 * q.numel() * elt + 2 * kv_rows * Hkv * D * elt
    pairs = int(cost.visible(S, T, offsets, causal, window, prefix).sum())
    return _old_bound_of(nbytes, 4 * D * Hq * pairs, q.dtype)


@pytest.mark.parametrize("case", range(6))
def test_attention_bounds_are_the_smoke_scripts(case):
    """``bound_ms`` and ``attn_bwd_bound`` from the shapes alone give the
    numbers the smoke script's tensor-counted formulas gave."""
    B, S, T, Hq, Hkv, D, offs, causal, window, prefix, dt = [
        (2, 64, 64, 4, 2, 64, [0, 0], True, 0, None, torch.bfloat16),
        (3, 1, 512, 16, 16, 64, [0, 255, 511], True, 0, None, torch.float32),
        (2, 1, 512, 16, 16, 64, [-12, 700], True, 0, None, torch.bfloat16),
        (1, 48, 128, 8, 1, 256, [80], True, 32, None, torch.bfloat16),
        (2, 40, 40, 8, 1, 256, [0, 0], True, 0, 16, torch.float32),
        (2, 32, 96, 4, 4, 16, [0, 0], False, 0, None, torch.float32)][case]
    q = torch.zeros(B, S, Hq, D, dtype=dt)
    k = torch.zeros(B, T, Hkv, D, dtype=dt)
    assert cost.bound_ms(q, k, offs, causal, window, prefix) == \
        _old_attention(q, k, offs, causal, window, prefix)
    if all(o == 0 for o in offs):
        kw = dict(causal=causal, window=window, prefix_len=prefix)
        pairs = int(cost.visible(S, T, [0] * B, causal, window,
                                 prefix).sum())
        want = _old_bound_of((4 * q.numel() + 4 * k.numel())
                             * q.element_size() + B * Hq * S * 4,
                             2.5 * 4 * D * Hq * pairs, dt)
        assert cost.attn_bwd_bound(q, k, kw) == want


def test_other_bounds_are_the_smoke_scripts():
    """The SSD's, RG-LRU's, router's, combine's and Fletcher's bounds at
    mamba2's, recurrentgemma's and granite's shapes, as the smoke script
    computed them before the move."""
    tf32 = 495e12
    for dt in (torch.float32, torch.bfloat16):
        x, Bm = torch.zeros(2, 300, 64, 64, dtype=dt), \
            torch.zeros(2, 300, 1, 128, dtype=dt)
        elt = x.element_size()
        for has_D, has_h0 in ((1, 0), (1, 1), (0, 0)):
            nbytes = (2 * x.numel() + 2 * Bm.numel()) * elt \
                + 4 * 2 * 300 * 64 + 4 * 64 * (1 + has_D) \
                + 4 * 2 * 64 * 64 * 128 * (1 + has_h0)
            fma = 2 * 300 * 64 * (2 * 64 * 128 + 64 * has_D)
            assert cost.ssd_bound(x, Bm, has_D, has_h0) == \
                _old_bound_of(nbytes, 2 * fma, dt, peak=tf32)
            nc = 5
            nbytes = (3 * x.numel() + 4 * Bm.numel()) * elt \
                + 8 * 2 * 300 * 64 + 4 * 64 * (2 + 2 * has_D) \
                + 4 * 2 * 64 * 64 * 128 * (has_h0 + 1) \
                + 4 * 2 * nc * 64 * (64 * 128 + 1)
            fma = 2 * 300 * 64 * (5 * 64 * 128 + 2 * 64 * has_D)
            assert cost.ssd_bwd_bound(x, Bm, has_D, has_h0, 1, nc) == \
                _old_bound_of(nbytes, 2 * fma, dt, peak=tf32)
        xr = torch.zeros(4, 160, 2048, dtype=dt)
        n, e = xr.numel(), xr.element_size()
        assert cost.rglru_bound(xr, 1, 5) == _old_bound_of(
            4 * n * e + 4 * 2048 + 4 * 4 * 2048 * 2 + 4 * 4 * 2048 * 5, 15 * n,
            dt)
        assert cost.rglru_bwd_bound(xr, 0, 1, 5) == _old_bound_of(
            7 * n * e + 8 * 2048 + 4 * 4 * 2048 * 2 + 4 * 4 * 2048 * 5,
            30 * n, torch.float32)
        out_buf = torch.zeros(40 * 64, 1536, dtype=dt)
        slot = torch.tensor([[0, 5], [2559, 2560], [7, 9]] * 4,
                            dtype=torch.int32)
        kept = int((slot < 2560).sum())
        size = out_buf.element_size()
        assert cost.combine_bound(out_buf, slot) == _old_bound_of(
            kept * 1536 * size + 8 * 12 * 2 + 12 * 1536 * size,
            2 * kept * 1536, torch.float32)
        assert cost.combine_bwd_bound(out_buf, slot, 40) == _old_bound_of(
            (12 + kept + 2560) * 1536 * size + 12 * 12 * 2 + 4 * 2560
            + 12 * 12 * 40 + 4 * 40 + 4,
            3 * kept * 1536 + 8 * 12 * 40 + 4 * 12 * 2, torch.float32)
    T, E, k, e_local, C = 1024, 40, 8, 20, 256
    assert cost.router_bound(T, E, k, e_local, C) == _old_bound_of(
        8 * T * E + 12 * T * k + 4 * e_local * C + 8 * E + 4,
        (4 + 2 * k) * T * E, torch.float32)
    assert cost.router_bwd_bound(T, E, k) == _old_bound_of(
        12 * T * E + 12 * T * k + 4 * E + 4, 8 * T * E + 4 * T * k,
        torch.float32)
    xs = [torch.zeros(1000, dtype=torch.uint8), torch.zeros(33, 7)]
    nbytes = sum(x.numel() * x.element_size() for x in xs)
    words = sum((x.numel() * x.element_size() + 3) // 4 for x in xs)
    assert cost.fletcher_bound(xs) == _old_bound_of(
        nbytes + 32 * len(xs) + 8, 2 * words, torch.float32)
