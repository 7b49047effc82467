"""The readers of the program's regions (``benchlib/regions.py``) on
synthetic traces: the idle parts split ``device.idle_share.train``, a
nested or repeated region counts once, every reader gives None on an
incomplete trace and on one without ``train.step`` regions, and the
regions' host events leave the window's busy time as it was.  Then a
tiny traced run on the CPU: the program's regions reach the benchmark's
trace."""
import random

import pytest

import benchtiny
from benchlib import harness, probes, regions, spec
from benchlib.result import Run

NEW = ("device.idle_share.train.model", "device.idle_share.train.optimizer",
       "device.idle_share.train.between_steps",
       "train.optimizer_share.program", "datafeed.rpc_wait_ms")
WINDOW = (1_000, 11_000)

# two steps: feed (get ⊃ wait), then step ⊃ forward, backward, optimizer
HOST = [
    (1_000, 1_400, "datafeed.get"), (1_050, 1_350, "datafeed.wait"),
    (1_500, 5_500, "train.step"), (1_600, 3_000, "train.forward"),
    (3_000, 5_000, "train.backward"), (5_000, 5_400, "train.optimizer"),
    (6_000, 6_600, "datafeed.get"), (6_100, 6_500, "datafeed.wait"),
    (6_700, 10_700, "train.step"), (6_800, 8_000, "train.forward"),
    (8_000, 10_200, "train.backward"), (10_200, 10_600, "train.optimizer"),
]
# (start, end, name, launch time): kernels with gaps in every part
DEVICE = [
    (1_700, 2_800, "gemm", 1_650), (3_100, 4_900, "attn_bwd", 3_050),
    (5_050, 5_300, "adam", 5_020), (5_600, 5_900, "loss", 5_510),
    (6_900, 7_900, "gemm", 6_850), (8_100, 10_000, "attn_bwd", 8_050),
    (10_250, 10_550, "adam", 10_220), (10_800, 10_900, "loss", 10_710),
]


def make_trace(host=HOST, device=DEVICE, extra_ranges=None):
    tr = probes.Trace(device=list(device), host=list(host))
    tr.ranges["bench.window"].append(WINDOW)
    for name, spans in (extra_ranges or {}).items():
        tr.ranges[name] = list(spans)
    tr.stats = {"launches": len(device), "kernels": len(device)}
    return tr


def make_run(tr):
    run = Run("c", trace=tr)
    _, run.counters, run.breakdown = probes.window_counters(tr, {})
    return run


def read(run):
    return {m: harness.read_metric(m, run) for m in NEW + (
        "device.idle_share.train", "train.optimizer_share")}


def test_idle_parts_split_the_idle_share():
    run = make_run(make_trace())
    got = read(run)
    parts = regions.idle_parts(run)
    w = WINDOW[1] - WINDOW[0]
    # by hand, step by step: idle inside forward and backward, inside the
    # optimizer, inside a step but none of those, outside the steps
    model = (100 + 200 + 100 + 100) + (100 + 100 + 100 + 200)
    opt = (50 + 100) + (50 + 50)
    step_rest = (100 + 100) + (100 + 100)
    between = 500 + 100 + 800 + 100 + 100
    assert got["device.idle_share.train.model"] == pytest.approx(
        100 * model / w)
    assert got["device.idle_share.train.optimizer"] == pytest.approx(
        100 * opt / w)
    assert parts["in_step"] == pytest.approx(100 * step_rest / w)
    assert got["device.idle_share.train.between_steps"] == pytest.approx(
        100 * between / w)
    total = (parts["model"] + parts["optimizer"] + parts["in_step"]
             + parts["between_steps"])
    assert total == pytest.approx(got["device.idle_share.train"], abs=1e-9)
    assert total == pytest.approx(100 * 3_250 / w)


def test_in_step_remainder_closes_the_sum():
    """Idle time inside a step but outside its parts (the microbatches'
    sums) lands in the remainder, and the four still sum to the share."""
    host = [h for h in HOST if h[2] != "train.optimizer"]
    run = make_run(make_trace(host=host))
    parts = regions.idle_parts(run)
    assert parts["optimizer"] == 0 and parts["in_step"] > 0
    total = (parts["model"] + parts["optimizer"] + parts["in_step"]
             + parts["between_steps"])
    assert total == pytest.approx(
        harness.read_metric("device.idle_share.train", run), abs=1e-9)


def test_nested_or_repeated_regions_count_once():
    base = read(make_run(make_trace()))
    more = HOST + [
        (1_600, 3_000, "train.forward"),          # repeated
        (1_700, 2_000, "train.forward"),          # nested in one
        (1_550, 5_450, "train.step"),             # nested step
        (5_100, 5_200, "train.optimizer"),
        (1_060, 1_340, "datafeed.wait"),          # nested wait
    ]
    again = read(make_run(make_trace(host=more)))
    for name in NEW:
        if name == "datafeed.rpc_wait_ms":
            continue
        assert again[name] == pytest.approx(base[name]), name
    assert again["datafeed.rpc_wait_ms"] == pytest.approx(
        base["datafeed.rpc_wait_ms"])
    assert base["datafeed.rpc_wait_ms"] == pytest.approx((300 + 400) / 2e6)


def test_every_reader_is_none_without_a_complete_trace_or_regions():
    incomplete = make_trace()
    incomplete.stats = {"launches": 10, "kernels": 1}
    no_steps = make_trace(host=[h for h in HOST if h[2] != "train.step"])
    no_regions = make_trace(host=[(0, 5, "aten::mul")])
    for tr in (incomplete, no_steps, no_regions):
        run = make_run(tr)
        assert all(harness.read_metric(m, run) is None for m in NEW)
    bare = type("R", (), {"spans": {}, "counters": {}})()
    assert all(harness.read_metric(m, bare) is None for m in NEW)


def test_host_regions_leave_the_busy_time_unchanged():
    with_regions = probes.window_counters(make_trace(), {})
    without = probes.window_counters(make_trace(host=[]), {})
    assert with_regions[1]["device.busy_s"] == without[1]["device.busy_s"]
    assert with_regions[1]["device.window_s"] == without[1]["device.window_s"]
    assert with_regions[2]["device_ops"] == without[2]["device_ops"]


def test_program_optimizer_share_matches_the_benchmarks_ranges():
    """Over the same intervals, the regions' share is the ``bench.*``
    ranges' share, as ``Trace.launched_in`` reckons both."""
    ranges = {"bench.train_step": [(s, e) for s, e, n in HOST
                                   if n == "train.step"],
              "bench.optimizer": [(s, e) for s, e, n in HOST
                                  if n == "train.optimizer"]}
    run = make_run(make_trace(extra_ranges=ranges))
    run.counters["train.step_device_s"] = run.trace.launched_in(
        "bench.train_step")
    run.counters["train.optimizer_device_s"] = run.trace.launched_in(
        "bench.optimizer")
    got = read(run)
    assert got["train.optimizer_share.program"] == pytest.approx(
        got["train.optimizer_share"])
    assert got["train.optimizer_share.program"] == pytest.approx(
        100 * (250 + 300) / (1_100 + 1_800 + 250 + 1_000 + 1_900 + 300))


def _points(ivs):
    return {t for s, e in ivs for t in range(s, e)}


def _random_union(rng):
    starts = [rng.randint(0, 60) for _ in range(rng.randint(0, 6))]
    return regions.union((s, s + rng.randint(0, 12)) for s in starts)


def test_interval_arithmetic_against_points():
    rng = random.Random(7)
    for _ in range(300):
        a, b = _random_union(rng), _random_union(rng)
        assert _points(regions.intersect(a, b)) == _points(a) & _points(b)
        assert _points(regions.minus(a, b)) == _points(a) - _points(b)
        assert regions.length(a) == len(_points(a))
        assert all(x[1] < y[0] for x, y in zip(a, a[1:]))


def test_the_programs_regions_reach_the_benchmarks_trace():
    """A tiny traced run on the CPU: each profiled step's ``train.step``
    region lies inside the benchmark's ``bench.train_step`` range and the
    window, and a ``datafeed.wait`` a step precedes it."""
    cell = benchtiny.tiny_cell(spec.load_spec()["workloads"][0]["name"])
    run = benchtiny.run_tiny(cell, trace=True)
    tr = run.trace
    (lo, hi), = tr.ranges["bench.window"][:1]
    steps = regions.spans(tr, "train.step")
    outer = tr.ranges["bench.train_step"]
    assert len(steps) == len(outer) >= 1
    for (s, e), (bs, be) in zip(steps, sorted(outer)):
        assert bs <= s < e <= be and lo <= s and e <= hi
    waits = regions.intersect(regions.spans(tr, "datafeed.wait"),
                              [(lo, hi)])
    assert len(waits) == len(steps)
    assert regions.spans(tr, "train.forward") and regions.spans(
        tr, "train.backward") and regions.spans(tr, "train.optimizer")
