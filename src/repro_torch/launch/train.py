"""Training launcher wired to the Mercury services, ported from
``src/repro/launch/train.py``.

Single-process topology, as the reference's (its multi-process topology
is the same code with tcp URIs); the engines use the in-process self
plugin, or tcp when ``--ckpt-uri`` names an external server (a self-only
trainer could not reach it):
  * a checkpoint server engine (restore on start with ``--resume``, an
    async save of the state on the device every ``--ckpt-every`` steps
    and at the end; Fletcher-64 checksums every shard where it lies and
    the server verifies them on ``--device``),
  * a datafeed engine hosting the token pipeline, pulled over RPC,
  * a membership coordinator the trainer joins and leaves,
  * the train step of ``repro_torch.train.step`` on ``--device``
    (default ``cuda``: the attention, router, SSD and RG-LRU kernels and
    their backwards; ``--arch`` any config of ``repro_torch.configs``).
    A config with a frontend (paligemma-3b's patches, seamless-m4t's
    frames) gets seeded frontend batches beside the tokens; a VLM's
    targets are padded with -1 over its patch positions.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train           # the card
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 4 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.executor import Engine
from repro_torch.core.types import MercuryError
from repro_torch.data.pipeline import SyntheticSource
from repro_torch.models import Model
from repro_torch.models.common import resolve_device
from repro_torch.services import (CheckpointClient, CheckpointServer,
                                  DataFeedClient, DataFeedServer,
                                  MembershipClient, MembershipServer)
from repro_torch.train import optim
from repro_torch.train.step import init_state, make_train_step

BATCH_KEYS = ("tokens", "targets", "frontend")


def vlm_targets(targets, n_patches: int):
    """A VLM's targets (B,S) padded with -1 (no target) over the
    ``n_patches`` patch positions that come before the text."""
    pad = targets.new_full((targets.shape[0], n_patches), -1)
    return torch.cat([pad, targets], dim=1)


def main(argv=None) -> dict:
    """Train; returns {"losses", "grad_norms", "steps", "tokens",
    "seconds", "step_seconds", "checkpoints"}: ``seconds`` is the loop's
    host wall-clock, saves included; ``step_seconds`` each step's, from
    fetching its batch to reading its loss, its save's snapshot
    included."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-uri", default=None,
                    help="external checkpoint server URI (tcp://…)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the state, the step and the "
                         "checksums; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.reduced(args.arch) if args.reduced else configs.get(args.arch)
    model = Model(cfg)
    opt_cfg = optim.OptConfig(lr=args.lr, warmup=5, decay_steps=args.steps)
    par = ParallelConfig(microbatches=args.microbatches, remat="none")

    # --- services -----------------------------------------------------------
    addr = "tcp://127.0.0.1:0" if args.ckpt_uri else None
    trainer = Engine(addr)
    engines = [trainer]
    if args.ckpt_uri:
        ckpt_server_uri = args.ckpt_uri
    else:
        ckpt_engine = Engine(addr)
        engines.append(ckpt_engine)
        CheckpointServer(ckpt_engine, device=device)
        ckpt_server_uri = ckpt_engine.uri
    ckpt = CheckpointClient(trainer, ckpt_server_uri)

    feed_engine = Engine(addr)
    coord = Engine(addr)
    engines += [feed_engine, coord]
    frontend = None
    if cfg.frontend != "none":
        frontend = (cfg.frontend_seq, cfg.frontend_dim)
    source = SyntheticSource(cfg.vocab, args.seq, args.batch,
                             frontend=frontend)
    DataFeedServer(feed_engine, source)
    feed = DataFeedClient(trainer, [feed_engine.uri], depth=2)

    MembershipServer(coord)
    member = MembershipClient(trainer, coord.uri, "trainer-0")
    member.join({"role": "trainer"})
    try:
        # --- state ----------------------------------------------------------
        state = init_state(model, opt_cfg, 0, device=device)
        start_step = 0
        if args.resume:
            try:
                state, start_step = ckpt.restore(cfg.name, state,
                                                 device=device)
                print(f"resumed from step {start_step}")
            except MercuryError as e:
                print(f"no checkpoint to resume ({e}); starting fresh")

        step_fn = make_train_step(model, opt_cfg, par)

        # --- loop -----------------------------------------------------------
        t0 = time.monotonic()
        pending_save = None
        losses, gnorms, step_seconds = [], [], []
        last = start_step + args.steps - 1
        for step in range(start_step, start_step + args.steps):
            t_step = time.monotonic()
            raw = feed.get(step)
            batch = {k: torch.tensor(raw[k], device=device)
                     for k in BATCH_KEYS if k in raw}
            if cfg.family == "vlm":
                batch["targets"] = vlm_targets(batch["targets"],
                                               cfg.frontend_seq)
            state, metrics = step_fn(state, batch)
            if (step + 1) % args.ckpt_every == 0 or step == last:
                if pending_save is not None:
                    pending_save.result(timeout=120)
                pending_save = ckpt.async_save(cfg.name, step + 1, state)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
            step_seconds.append(time.monotonic() - t_step)
            print(f"step {step:4d} loss={losses[-1]:.4f} "
                  f"gnorm={gnorms[-1]:.3f} "
                  f"lr={float(metrics['lr']):.2e}")
        if pending_save is not None:
            print("final checkpoint:", pending_save.result(timeout=120))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.monotonic() - t0
        toks = args.steps * args.batch * args.seq
        checkpoints = ckpt.list()
        print(f"{args.steps} steps, {toks} tokens, {dt:.1f}s "
              f"({toks / dt:.0f} tok/s); checkpoints: {checkpoints}")
    finally:
        member.leave()
        for e in engines:
            e.shutdown()
    return {"losses": losses, "grad_norms": gnorms, "steps": args.steps,
            "tokens": toks, "seconds": dt, "step_seconds": step_seconds,
            "checkpoints": checkpoints}


if __name__ == "__main__":
    main()
