"""The cell driven whole on the CPU at the port's reduced sizes: set-up,
the window, the reference's comparison; the control (the reference in
float8 in the program's place) and the faults a training cell can have,
planted in the timed path, each come out as not correct.  The same for
the tests' own DeepSeekMoE file (``bench/tests/fixtures``), as a cell of
a copy of ``BENCHMARK.json``, and a reference given the other
``norm_topk_prob`` than the program runs."""
import json

import pytest

import benchtiny
from benchlib import check, result, spec, train
from benchlib.result import Run

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]
CELL = CELLS[0]


def moe_cell():
    """The fixture's cell, through the path every cell of
    ``BENCHMARK.json`` takes, held to its family's limits."""
    return benchtiny.tiny_cell(benchtiny.FIXTURE_CELLS[0]["name"],
                               benchtiny.with_fixture_cells())


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct(workload, trace):
    runs_correct(benchtiny.tiny_cell(workload), trace)


@pytest.mark.parametrize("trace", [False, True])
def test_the_moe_cell_runs_correct(trace):
    runs_correct(moe_cell(), trace)


def runs_correct(cell, trace):
    run = benchtiny.run_tiny(cell, trace=trace)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0
    assert all(v > 0 for v in run.e2e.values())
    assert run.setup_s > 0
    assert [c[0] for c in run.checks] == list(check.limits(cell))
    assert "loss_gap (not compared)" in run.notes
    if trace:
        assert run.counters["model.flops"] > 0
        assert run.spans["datafeed.wait_ms"]


def test_result_line_ends_with_the_numbers_compared():
    run = Run("c", attempted=3, checks=[("loss_gap", 0.5, 1.0)])
    line = json.loads(result.line(run, {"m": {"value": 1.0, "unit": "s"}},
                                  {"platform": "gpu"}, False))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["checks"] == {"loss_gap": {"value": 0.5, "limit": 1.0}}
    assert result.checks_text(run) == ["check loss_gap 0.5 limit 1.0 ok"]
    run.checks.append(("grad_gap", 2.0, 1.0))
    assert not run.correct


def _unchanged(step):
    """A step that returns its state unchanged."""
    def broken(state, batch):
        keep = train.paths(state)
        saved = {k: v.clone() for k, v in keep.items()}
        state, met = step(state, batch)
        for k, v in keep.items():
            v.copy_(saved[k])
        return state, met
    return broken


def _half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def broken(state, batch):
        return step(state, {k: v[: len(v) // 2] for k, v in batch.items()})
    return broken


def _wrong_token(step):
    """A token altered where it is produced: each row's last input token
    replaced by its neighbour in the vocabulary."""
    def broken(state, batch):
        toks = batch["tokens"].clone()
        toks[:, -1] = toks[:, -1] % (toks.max() + 1) + 1
        return step(state, dict(batch, tokens=toks))
    return broken


@pytest.mark.parametrize("plant", [_unchanged, _half_batch, _wrong_token])
def test_a_training_fault_is_not_correct(plant):
    run = benchtiny.run_tiny(benchtiny.tiny_cell(CELL), plant=plant)
    assert not run.correct, run.checks


@pytest.mark.parametrize("plant", [_unchanged, _half_batch, _wrong_token])
def test_a_moe_training_fault_is_not_correct(plant):
    run = benchtiny.run_tiny(moe_cell(), plant=plant)
    assert not run.correct, run.checks


def test_a_reference_renormalising_otherwise_is_not_correct(monkeypatch):
    """A reference given the other ``norm_topk_prob`` than the program
    runs refuses its run."""
    steps = train.reference_steps

    def flipped(cfg, *args, **kw):
        return steps(dict(cfg, norm_topk_prob=not cfg["norm_topk_prob"]),
                     *args, **kw)
    monkeypatch.setattr(train, "reference_steps", flipped)
    run = benchtiny.run_tiny(moe_cell())
    assert not run.correct, run.checks


def control_fails(cell):
    limits = check.limits(cell)
    seed = 3141592653
    ref = train.reference_steps(cell.config, cell.traffic, seed, "cpu")
    got = train.reference_steps(cell.config, cell.traffic, seed, "cpu",
                                quant="fp8")
    nums = check.training_numbers(got, ref)
    assert any(nums[k] > lim for k, lim in limits.items()), nums
    same = check.training_numbers(ref, ref)
    assert all(v == 0 for v in same.values())


def test_the_float8_control_fails_training():
    control_fails(benchtiny.tiny_cell(CELL))


def test_the_float8_control_fails_moe_training():
    control_fails(moe_cell())
