#!/usr/bin/env python3
"""Where a training step's time goes, on one NVIDIA card.

    python3 tools/train_profile.py    # 8 x 128, 4 x 1024, then 8 x 4096
    python3 tools/train_profile.py --arch mamba2-1.3b --arch granite-moe-3b-a800m
    python3 tools/train_profile.py --arch recurrentgemma-9b
    python3 tools/train_profile.py --arch gemma3-12b --arch deepseek-moe-16b
    python3 tools/train_profile.py --arch recurrentgemma-9b --layers 38 \
        --opt adafactor --remat block

Full-width models (bf16 compute, f32 state, AdamW; remat "none" at the
launcher's 8 x 128, and for qwen1.5-0.5b, the default, also "block" at
4 x 1024 and "none" at the benchmark cell's 8 x 4096), seeded weights and batches, no services.  Full depth, but
recurrentgemma-9b at ``chip_smoke.py``'s cut (``HYBRID_TRAIN_LAYERS``):
its 38 layers' state does not fit one 80 GB card with AdamW; and
gemma3-12b, deepseek-moe-16b and command-r-35b at the cut, optimizer and
shape of their rows of ``chip_smoke.py``'s ``TRAIN_BREADTH``.
``--layers``, ``--opt`` and ``--remat`` override a model's (every model
profiled).  The reckoned bytes of the parameters, gradients and
optimizer state (``chip_smoke.train_state_bytes``) are printed before
the state is made.  After two warm-up steps, 3 steps of ``train.step``'s
own step run as a trainer runs them, nothing wrapped, the card
synchronised once after the last: ``step_ms`` is their wall-clock a
step, ``tokens_per_s`` a step's tokens over it and ``peak_gib`` the peak
of device memory allocated over them.  Then ``torch.profiler`` over 3
more, every thread and the card as the benchmark's traced runs take
them, read by the benchmark's reader (``bench/benchlib/probes.py``,
``regions.py``): ``forward_ms``, ``backward_ms`` and ``optimizer_ms``
are the device time a step of the operations launched inside the
program's ``train.forward``, ``train.backward`` and ``train.optimizer``
regions (``telemetry.trace.region``), by their launch's host time, as
the benchmark's ``train.optimizer_share.program`` reckons them (the
backward's include remat's recompute); beside them, device time by
kernel (self CUDA time), the device's busy share of the profiled window
(the union of its operations' intervals over wall-clock; the profiler's
own cost slows a host-paced step) and the kernel launches a step.

Each measurement is one line ``PROFILE {json}`` on stdout; a model
whose step runs out of the card's memory gives one with
``out_of_memory`` and the peak up to the failed allocation, and the
tool exits 1 after the others.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "bench")]

import torch  # noqa: E402

from benchlib import probes, regions  # noqa: E402
from chip_smoke import (HYBRID_ARCH, HYBRID_TRAIN_LAYERS,  # noqa: E402
                        TRAIN_BREADTH, train_state_bytes)
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticSource  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train import step as train_step  # noqa: E402

ARCH = "qwen1.5-0.5b"
# (batch, seq, remat) by model: the launcher's shape for each, and qwen's
# long step of chip_smoke.py phase 3g and the benchmark cell's step
SHAPES = {ARCH: ((8, 128, "none"), (4, 1024, "block"), (8, 4096, "none"))}
LAUNCHER_SHAPE = ((8, 128, "none"),)
# the depth a model is cut to, where its state does not fit one card,
# and its optimizer where AdamW's state does not fit at that depth
LAYERS = {HYBRID_ARCH: HYBRID_TRAIN_LAYERS}
OPT = {}
for _, _arch, _layers, _opt, _, _batch, _seq, _ in TRAIN_BREADTH:
    LAYERS[_arch], OPT[_arch] = _layers, _opt
    SHAPES[_arch] = ((_batch, _seq, "none"),)
WARM, TIMED, PROFILED = 2, 3, 3
PARTS = ("forward", "backward", "optimizer")


def emit(**row):
    print("PROFILE", json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", action="append",
                    help=f"model to profile (repeat for several; default "
                         f"{ARCH})")
    ap.add_argument("--layers", type=int, help="cut every model to this "
                    "depth")
    ap.add_argument("--opt", choices=("adamw", "adafactor"),
                    help="the optimizer of every model")
    ap.add_argument("--remat", choices=("none", "block"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    rc = 0
    for arch in args.arch or [ARCH]:
        try:
            profile_arch(arch, args)
        except torch.cuda.OutOfMemoryError as e:
            # the state did not fit: its peak up to the failed allocation
            emit(arch=arch, out_of_memory=True,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 error=str(e).splitlines()[0][:300])
            rc = 1
        torch.cuda.empty_cache()
    return rc


def profile_arch(arch: str, args) -> None:
    cfg = configs.get(arch)
    layers = args.layers or LAYERS.get(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    model = Model(cfg)
    opt = args.opt or OPT.get(arch, "adamw")
    ocfg = optim.OptConfig(name=opt, warmup=5, decay_steps=100)
    for B, S, remat in SHAPES.get(arch, LAUNCHER_SHAPE):
        remat = args.remat or remat
        reckoned = train_state_bytes(arch, cfg.n_layers, opt)
        emit(arch=arch, shape=f"{B}x{S}", layers=cfg.n_layers, opt=opt,
             reckoned_bytes=reckoned)
        state = train_step.init_state(model, ocfg, 0, device="cuda")
        step = train_step.make_train_step(model, ocfg,
                                          ParallelConfig(remat=remat))
        source = SyntheticSource(cfg.vocab, S, B)
        batches = [{k: torch.from_numpy(v).cuda()
                    for k, v in source.batch_at(i).items()}
                   for i in range(WARM + TIMED + PROFILED)]
        for i in range(WARM):
            state, metrics = step(state, batches[i])
        float(metrics["loss"])
        probes.warm_profiler("cuda")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        for i in range(TIMED):
            state, metrics = step(state, batches[WARM + i])
        torch.cuda.synchronize()
        step_s = (time.monotonic() - t0) / TIMED
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.monotonic()
        with probes.profile() as prof:
            for i in range(PROFILED):
                state, metrics = step(state, batches[WARM + TIMED + i])
            torch.cuda.synchronize()
        window = time.monotonic() - t0
        tr = probes.read_trace(prof)
        part_ms = {part: regions.launched(tr, f"train.{part}") * 1e3
                   / PROFILED for part in PARTS}
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        launches = sum(e.count for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
        emit(arch=arch, shape=f"{B}x{S}", remat=remat, opt=opt,
             layers=cfg.n_layers,
             **{f"{part}_ms": ms for part, ms in part_ms.items()},
             step_ms=step_s * 1e3, peak_gib=peak,
             tokens_per_s=B * S / step_s,
             profiled_window_ms=window * 1e3,
             device_busy_ms_per_step=tr.busy_ns() / 1e6 / PROFILED,
             device_busy_share=tr.busy_ns() / 1e9 / window,
             kernel_launches_per_step=launches / PROFILED)
        for e in top:
            emit(arch=arch, shape=f"{B}x{S}", kernel=e.key[:120],
                 device_ms_per_step=e.self_device_time_total / 1e3 / PROFILED,
                 calls_per_step=e.count / PROFILED)
        del state, step, batches
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
