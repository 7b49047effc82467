#!/usr/bin/env python3
"""Before and after on one NVIDIA card: the MoE layer's launches and host
syncs, granite's serving wall-clock and the qwen checkpoint's, for two
or more checkouts of the repository, in turns.

    python3 tools/dispatch_ab.py ROOT_A ROOT_B      # A, B, B, A
    python3 tools/dispatch_ab.py --one ROOT         # one checkout, once
    python3 tools/dispatch_ab.py --layer ROOT_A ROOT_B   # part 1 alone

Each turn runs in its own process, which imports ``repro_torch`` and
``chip_smoke.py`` from that checkout alone (this script's own helpers
need nothing newer), builds its kernels, and measures:

1. One MoE layer call at granite-moe-3b-a800m's width (40 experts,
   top-8, d 1536, bf16 compute, f32 weights), dropless on a decode
   step's 4 tokens and a 64-token chunk, and at training's capacity
   factor 1.25 on 8 x 128 tokens (T 1024, C 256): the device activities
   ``torch.profiler`` sees from the router matmul's output to y (the
   layer's less the router matmul's and the expert products'), the host
   syncs ``torch.cuda``'s sync debug mode reports, and the call's host
   wall-clock ending in a synchronise (mean of 20).  At T 1024 also the
   training call: the layer's forward and autograd's backward of
   ``(y * dy).sum()`` with the aux losses, every device activity
   counted (``train_launches``), and their device time
   (``train_device_ms``, the activities' sum).  Each call's host time,
   the card idle at its start and not waited for (``host_ms``,
   ``train_host_ms``: median of 20), and the training call's wall-clock
   ending in a synchronise (``train_call_ms``).
2. granite-moe-3b-a800m serving through the checkout's ``chip_smoke.py``
   phases: the launcher's demo (weight init included) and the session
   phase, each phase's host wall-clock, and every ``Model.decode_step``
   call's host wall-clock ending in a synchronise.
3. qwen1.5-0.5b's full-width weights saved from the card to a
   ``CheckpointServer`` over tcp and restored, twice: save and restore
   host wall-clock and Fletcher-64 launches of each.

Each measurement is one line ``AB {json}`` on stdout, with the card's
name and power limit.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

MOE_ARCH = "granite-moe-3b-a800m"
CKPT_ARCH = "qwen1.5-0.5b"


def emit(**row):
    print("AB", json.dumps(row), flush=True)


def device_events(torch, fn) -> list:
    """Names of the device activities one call of ``fn`` puts on the
    card, by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def host_syncs(torch, fn) -> int:
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def call_ms(torch, fn, iters: int = 20) -> float:
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / iters * 1e3


def host_ms(torch, fn, iters: int = 20) -> float:
    """Median host time of one call of ``fn`` in ms, the card idle at its
    start and not waited for at its end: what the call costs the host to
    put its work on the card."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[iters // 2]


def moe_layer(cs, torch, tag):
    from repro_torch.models.common import dtype_of
    moe = cs.moe_layer
    cfg = cs.configs.get(MOE_ARCH)
    cdt = dtype_of(cfg.compute_dtype)
    e_pad = moe.padded_experts(cfg, 1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    params = moe.moe_params(cfg, gen, e_pad=e_pad)
    for name, T, dropless in (("decode", 4, True), ("chunk", 64, True),
                              ("train-T1024", 1024, False)):
        x2d = torch.randn((T, cfg.d_model), generator=gen,
                          device="cuda").to(cdt)
        cf = cfg.moe.capacity_factor
        C = T if dropless else max(int(math.ceil(
            T * cfg.moe.top_k / cfg.moe.num_experts * cf)), 1)

        def layer():
            return moe._moe_local(cfg, params, x2d, e_pad=e_pad,
                                  capacity_factor=cf, dropless=dropless)
        with torch.no_grad():
            layer()
            buf = x2d.new_zeros((e_pad, C, cfg.d_model))
            around = len(device_events(torch, lambda: (
                x2d.to(cdt) @ params["router"].to(cdt)).float())) + len(
                device_events(torch, lambda: moe._expert_ffn(cfg, params,
                                                             buf)))
            events = device_events(torch, layer)
            row = dict(launches=len(events) - around, events=events,
                       host_syncs=host_syncs(torch, layer),
                       call_ms=call_ms(torch, layer),
                       host_ms=host_ms(torch, layer))
        if not dropless:
            row.update(train_layer(torch, cfg, moe, params, x2d, e_pad, cf))
        emit(root=tag, what="moe_layer", case=name, T=T, C=C, **row)


def train_layer(torch, cfg, moe, params, x2d, e_pad, cf) -> dict:
    """The layer's training call at ``x2d``: forward and autograd's
    backward of (y * dy).sum() + the aux losses' sums, every device
    activity ``torch.profiler`` sees and their summed device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    x = x2d.detach().clone().requires_grad_()
    dy = torch.ones_like(x2d)

    def step():
        y, (_, prob_sum, z_sum, _) = moe._moe_local(
            cfg, leaves, x, e_pad=e_pad, capacity_factor=cf)
        loss = (y * dy).sum() + prob_sum.sum() + z_sum
        return torch.autograd.grad(loss, [x] + list(leaves.values()))
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return dict(train_launches=len(kernels), train_device_ms=busy_us / 1e3,
                train_host_ms=host_ms(torch, step),
                train_call_ms=call_ms(torch, step),
                train_events=[e.name for e in kernels])


def granite_serving(cs, torch, tag):
    cfg = cs.configs.get(MOE_ARCH)
    steps = []
    orig = cs.Model.decode_step

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        return out
    cs.Model.decode_step = timed
    try:
        for phase, fn in (("demo", cs.phase_demo),
                          ("sessions", cs.phase_sessions)):
            steps.clear()
            t0 = time.monotonic()
            fn(MOE_ARCH, cfg)
            wall = time.monotonic() - t0
            ordered = sorted(steps)
            emit(root=tag, what="granite_phase", phase=phase, seconds=wall,
                 decode_steps=len(steps),
                 decode_step_ms_mean=sum(steps) / max(len(steps), 1),
                 decode_step_ms_median=ordered[len(ordered) // 2]
                 if ordered else None)
            cs.free_card()
    finally:
        cs.Model.decode_step = orig


def checkpoint(cs, torch, tag):
    fl, ckpt = cs.fl, cs.ckpt
    model = cs.Model(cs.configs.get(CKPT_ARCH))
    params = model.init(3, device="cuda")
    server_e = cs.Engine("tcp://127.0.0.1:0")
    client_e = cs.Engine("tcp://127.0.0.1:0")
    try:
        ckpt.CheckpointServer(server_e)
        client = ckpt.CheckpointClient(client_e, server_e.uri)
        for i in range(2):
            before = fl.fletcher64.launches
            t0 = time.monotonic()
            client.save("qwen", i, params)
            t_save = time.monotonic() - t0
            mid = fl.fletcher64.launches
            t0 = time.monotonic()
            restored, _ = client.restore("qwen", params)
            torch.cuda.synchronize()
            t_restore = time.monotonic() - t0
            emit(root=tag, what="checkpoint", round=i, save_s=t_save,
                 restore_s=t_restore,
                 save_launches=mid - before,
                 restore_launches=fl.fletcher64.launches - mid)
            del restored
    finally:
        client_e.shutdown()
        server_e.shutdown()


def one(root: Path, layer_only: bool = False) -> None:
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import torch
    tag = str(root)
    emit(root=tag, what="card", card=cs.card_line(),
         torch=torch.__version__)
    cs.kbuild.build_all(cs.SOURCES)
    moe_layer(cs, torch, tag)
    cs.free_card()
    if layer_only:
        return
    granite_serving(cs, torch, tag)
    checkpoint(cs, torch, tag)


def main(argv) -> int:
    layer_only = argv[:1] == ["--layer"]
    argv = argv[1:] if layer_only else argv
    if argv[:1] == ["--one"]:
        one(Path(argv[1]).resolve(), layer_only)
        return 0
    roots = [Path(a).resolve() for a in argv]
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    order = roots + roots[::-1]
    for root in order:
        proc = subprocess.run([sys.executable, __file__]
                              + ["--layer"] * layer_only
                              + ["--one", str(root)], cwd=root)
        if proc.returncode != 0:
            print(f"dispatch_ab: {root} failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
