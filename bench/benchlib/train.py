"""A training cell's run: the port's ``make_train_step`` with AdamW on the
configuration's seeded weights, each step's rows pulled over tcp from a
``DataFeedServer`` by a ``DataFeedClient``.

Set-up builds the one training step, its model and its optimizer state,
and drives it through its first three steps through the window's own
feed and call: they are the steps the reference follows (``check.py``).
The window then starts steps until ``seconds`` have passed, each ending
in a read of its loss (as ``launch/train.py`` logs it), and closes when
the last of them ends; its steps' tokens over its seconds are
``train_tok_per_s`` (no step is cut in two by the window's edge).

With ``trace`` the first half of the window is plain (the feed's wait
and the model's operations a second), then ``PROFILED_STEPS`` steps run
under ``torch.profiler`` with the kernels' calls recorded, again (up to
``PROFILE_TRIES`` times) where the tracer dropped kernels.
"""
from __future__ import annotations

import gc
import json
import time
from typing import Dict

import torch

import families
from reference.common import AdamW, f32_exact

from . import check, portcfg, probes, traffic, weights
from .result import Run, note

PROFILED_STEPS, PROFILE_TRIES = 3, 3


def paths(tree, prefix="") -> Dict[str, torch.Tensor]:
    """Each leaf of a tree of dicts and lists by its dotted path."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(paths(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(paths(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def norms(tree) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in paths(tree).items()}


class Source:
    """The cell's rows, from the mix and the seed (``traffic.train_batch``):
    what the feeder serves."""

    def __init__(self, mix, vocab, seed):
        self.mix, self.vocab, self.seed = mix, vocab, seed

    def batch_at(self, step):
        return traffic.train_batch(self.mix, self.vocab, self.seed, step)


def opt_config(mix):
    from repro_torch.train import optim
    return optim.OptConfig(**mix["optimizer"])


def check_loss(mix) -> None:
    """The mix's logit z-loss coefficient is the one the port's loss
    applies (``Model.loss_fn``'s ``z_coef``, which the step does not
    set): the reference follows the mix."""
    import inspect

    from repro_torch.models import Model
    port = inspect.signature(Model.loss_fn).parameters["z_coef"].default
    if float(mix["lm_z_loss_coef"]) != float(port):
        raise ValueError(f"the mix's lm_z_loss_coef "
                         f"{mix['lm_z_loss_coef']} is not the port's {port}")


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", plant=None) -> Run:
    """One run of a training cell; ``plant`` (tests only) wraps the step
    function: a fault planted in the timed path."""
    out = Run(cell.name)
    prog = window(out, cell, seed, seconds, trace, t_start, device, plant)
    # the program's state is gone with ``window``'s frame: freed before
    # the reference runs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        out.notes["left_allocated_bytes"] = torch.cuda.memory_allocated()
    note("bench: notes " + json.dumps(out.notes, default=str))
    t = time.monotonic()
    ref = reference_steps(cell.config, cell.traffic, seed, device)
    out.notes["reference_s"] = time.monotonic() - t
    out.notes["reference_losses"] = ref["losses"]
    check.trained(out, cell, prog, ref)
    return out


def window(out: Run, cell, seed, seconds, trace, t_start, device, plant):
    """Set-up (the first three steps, read) and the window; fills ``out``
    and returns the program's readings of the first three steps."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.executor import Engine
    from repro_torch.models import Model
    from repro_torch.services import DataFeedClient, DataFeedServer
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step

    from counts import model as cm

    cfg, mix = cell.config, cell.traffic
    pc = portcfg.port_config(cfg)
    check_loss(mix)
    w = weights.stacked(cfg, seed, device, torch.float32)
    params = weights.port_tree(cfg, w)
    state = {"params": params, "opt": optim.adamw_init(params)}
    model = Model(pc)
    ocfg = opt_config(mix)
    step = make_train_step(model, ocfg, ParallelConfig(remat=mix["remat"]))
    if plant is not None:
        step = plant(step)
    tokens_a_step = int(mix["batch"]) * int(mix["seq_len"])
    flops_a_step = cm.train_flops(cfg, int(mix["batch"]), int(mix["seq_len"]))
    pr = probes.Probes() if trace else None

    with Engine("tcp://127.0.0.1:0") as feeder, \
            Engine("tcp://127.0.0.1:0") as trainer:
        DataFeedServer(feeder, Source(mix, cfg["vocab_size"], seed))
        feed = DataFeedClient(trainer, [feeder.uri], depth=2)
        waits, done = [], []

        def one(i):
            t = time.monotonic()
            raw = feed.get(i)
            waits.append((time.monotonic() - t) * 1e3)
            batch = {k: torch.tensor(raw[k], device=device)
                     for k in ("tokens", "targets")}
            with torch.profiler.record_function("bench.train_step"):
                _, met = step(state, batch)
            loss = float(met["loss"])
            done.append(time.monotonic())
            return loss

        # set-up: the first three steps, read for the comparison
        prog = {"losses": [one(0)]}
        prog["grad"] = {k: v / (1 - ocfg.b1)
                        for k, v in norms(state["opt"]["m"]).items()}
        prog["losses"] += [one(1), one(2)]
        p0 = weights.stacked(cfg, seed, device, torch.float32)
        p0_paths = paths(weights.port_tree(cfg, p0))
        prog["change"] = {
            k: float(torch.linalg.vector_norm(v - p0_paths[k]))
            for k, v in paths(state["params"]).items()}
        del p0, p0_paths
        if pr is not None:
            pr.install()
            probes.warm_profiler(device)
        gcw = probes.GCWatch().__enter__()

        t0 = time.monotonic()
        out.setup_s = t0 - t_start
        t_end = t0 + seconds
        i, first = 3, len(done)
        prof = None
        half = t0 + 0.5 * seconds
        profiled = 0
        while time.monotonic() < t_end:
            if trace and prof is None and time.monotonic() >= half \
                    and profiled == 0:
                if "plain.s" not in out.counters:
                    out.counters["plain.steps"] = sum(
                        1 for t in done[first:] if t <= time.monotonic())
                    out.counters["plain.s"] = time.monotonic() - t0
                    out.spans["datafeed.wait_ms"] = list(waits[first:])
                prof = probes.profile()
                prof.start()
                window = torch.profiler.record_function("bench.window")
                window.__enter__()
                pr.recording = True
            one(i)
            i += 1
            if prof is not None:
                profiled += 1
                if profiled % PROFILED_STEPS == 0:
                    pr.recording = False
                    window.__exit__(None, None, None)
                    prof.stop()
                    out.trace = probes.read_trace(prof)
                    prof = None
                    if not out.trace.complete and \
                            profiled < PROFILED_STEPS * PROFILE_TRIES:
                        profiled = 0       # the tracer dropped kernels
                        pr.calls.clear()
        if prof is not None:
            window.__exit__(None, None, None)
            prof.stop()
            out.trace = probes.read_trace(prof)
            prof = None
        gcw.__exit__(None, None, None)
        out.notes.update(gcw.summary())
        if pr is not None:
            pr.uninstall()
        # the window runs to the end of the last step it started: every
        # step counts whole, over all the seconds it took
        in_window = done[first:]
        window_s = in_window[-1] - t0
        out.attempted = i - 3
        out.e2e["train_tok_per_s"] = len(in_window) * tokens_a_step / window_s
        out.notes.update(steps_in_window=len(in_window), window_s=window_s,
                         setup_losses=prog["losses"],
                         flops_a_step=flops_a_step)
        if device == "cuda":
            torch.cuda.synchronize()
            out.peak_bytes = torch.cuda.max_memory_allocated()
        if trace:
            plain_steps = out.counters.get("plain.steps", len(in_window))
            plain_s = out.counters.get("plain.s", seconds)
            out.counters["model.flops"] = plain_steps * flops_a_step
            out.counters["model.step_s"] = plain_s
            out.spans.setdefault("datafeed.wait_ms", list(waits[first:]))
            traced(out, pr)

    return prog


def traced(out: Run, pr):
    """What the profiled steps of a traced run read."""
    got = None if out.trace is None else probes.window_counters(out.trace,
                                                                pr.calls)
    if got is None:
        return
    _, counters, out.breakdown = got
    counters["train.step_device_s"] = out.trace.launched_in("bench.train_step")
    counters["train.optimizer_device_s"] = out.trace.launched_in(
        "bench.optimizer")
    out.counters.update(counters)


def reference_steps(cfg, mix, seed, device, quant=None,
                    half_batch=False) -> dict:
    """The reference's three steps from the seed's weights and rows: each
    step's loss, the first step's clipped gradient's norm a leaf, and
    each leaf's change over the three.  ``quant`` and ``half_batch``
    make the control and a fault."""
    ref = check.reference_module(cfg)
    w = weights.stacked(cfg, seed, device, torch.float32)
    for t in w.values():
        t.requires_grad_(True)
    opt = dict(mix["optimizer"])
    for key, default in (("b1", 0.9), ("b2", 0.95), ("eps", 1e-8),
                         ("weight_decay", 0.1), ("grad_clip", 1.0),
                         ("warmup", 100), ("decay_steps", 10_000),
                         ("min_lr_frac", 0.1), ("lr", 3e-4)):
        opt.setdefault(key, default)
    adam = AdamW(opt, w, families.of(cfg).decays(cfg, w))
    dec = ref.Model(cfg, w, quant)
    out = {"losses": []}
    with f32_exact():
        for s in range(3):
            b = traffic.train_batch(mix, cfg["vocab_size"], seed, s)
            toks = torch.from_numpy(b["tokens"]).to(device)
            tgts = torch.from_numpy(b["targets"]).to(device)
            if half_batch:
                toks, tgts = toks[: len(toks) // 2], tgts[: len(tgts) // 2]
            loss, grads = dec.loss_grads(toks, tgts,
                                         float(mix["lm_z_loss_coef"]))
            used = adam.step(grads)
            out["losses"].append(loss)
            if s == 0:
                out["grad"] = norms(weights.port_tree(cfg, used))
            del grads, used
    del adam
    after = {k: v.detach() for k, v in w.items()}
    w0 = weights.stacked(cfg, seed, device, torch.float32)
    diff = {k: after[k] - w0[k] for k in after}
    out["change"] = norms(weights.port_tree(cfg, diff))
    return out
