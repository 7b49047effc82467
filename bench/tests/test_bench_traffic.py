"""Seeded training rows, and the end-to-end arithmetic: tokens a second
over every step of the window, each counted whole."""
import math
import time

import numpy as np

import benchtiny
from benchlib import traffic

MIX = {"batch": 2, "seq_len": 64, "zipf": 1.2}
BIG_SEED = 2**31 + 12345


def test_batches_are_seeded_and_in_range():
    b = traffic.train_batch(MIX, 1000, BIG_SEED, 0)
    assert b["tokens"].dtype == np.int32
    assert b["tokens"].shape == (2, 64) and b["targets"].shape == (2, 64)
    assert (b["tokens"][:, 1:] == b["targets"][:, :-1]).all()
    assert (b["tokens"][0] != b["tokens"][1]).any()
    assert b["tokens"].min() >= 1 and b["tokens"].max() < 1000
    again = traffic.train_batch(MIX, 1000, BIG_SEED, 0)
    assert (b["tokens"] == again["tokens"]).all()
    assert (b["tokens"] != traffic.train_batch(MIX, 1000, BIG_SEED, 1)
            ["tokens"]).any()
    assert (b["tokens"] != traffic.train_batch(MIX, 1000, BIG_SEED + 1, 0)
            ["tokens"]).any()


def test_every_seed_asks_for_the_same_work():
    """Every seed and step gives rows of one shape; the ids are skewed
    alike (a Zipf law over a seeded permutation of the vocabulary)."""
    tops = []
    for seed in (1, 2**40 + 3):
        b = traffic.train_batch(dict(MIX, seq_len=4096), 5000, seed, 0)
        assert b["tokens"].shape == (2, 4096)
        _, counts = np.unique(b["tokens"], return_counts=True)
        tops.append(np.sort(counts)[::-1][:3] / b["tokens"].size)
    assert np.allclose(tops[0], tops[1], atol=0.02)


def test_tokens_a_second_over_the_whole_window():
    """A step that takes 0.2 s or more: the window ends with the end of
    the last step it started, so it lasts the seconds asked for or more,
    and the rate is every step's tokens over all of it."""
    def slow(step):
        def timed(state, batch):
            time.sleep(0.2)
            return step(state, batch)
        return timed
    cell = benchtiny.tiny_cell(benchtiny.spec.load_spec()["workloads"][0]
                               ["name"])
    run = benchtiny.run_tiny(cell, seconds=1.0, plant=slow)
    n, secs = run.notes["steps_in_window"], run.notes["window_s"]
    assert n == run.attempted >= 1 and secs >= 1.0
    tokens = cell.traffic["batch"] * cell.traffic["seq_len"]
    assert math.isclose(run.e2e["train_tok_per_s"], n * tokens / secs)
