#!/usr/bin/env python3
"""Time the SSD's and the RG-LRU's kernels on one NVIDIA card.

    python3 tools/scan_tuning.py               # parts 1 and 2
    python3 tools/scan_tuning.py --passes      # part 2 only
    python3 tools/scan_tuning.py --main-shapes # part 3 only
    python3 tools/scan_tuning.py --bwd [DIR ...] # part 4 only
    python3 tools/scan_tuning.py --rglru-bwd [DIR ...] # part 5 only

1. Chunk lengths: ``chip_smoke.py``'s SSD check (the kernels against
   their plain version, timed in a CUDA graph with the L2 flushed, beside
   the bound) at mamba2-1.3b's heads (H 64, P 64, G 1, N 128) in f32 at
   B 1 and the main paths' S (5, 600, 1100, 2000, 2600), at the kernels'
   chunk of 64; the RG-LRU check at recurrentgemma-9b's width 4096, the
   same S, at L 16-256 forced and at ``CHUNK``.
2. The passes apart: ``torch.profiler`` over 10 calls of each at S 600
   and 2600, device time by kernel name (the L2 is not flushed between
   these calls).
3. Before and after: both checks at every S of the main paths (5-10,
   600, 1100, 2000, 2600) at the kernels' own chunk lengths, using only
   what ``chip_smoke.py`` had before the scans were split; a copy of this
   script in an older checkout times that checkout's kernels the same
   way.
4. The SSD's backward (``csrc/ssd_bwd.cu``) at mamba2-1.3b's heads, 8 ×
   128 and 2 × 1024 (with dh_final), f32 and bf16: its three passes
   apart by ``torch.profiler`` (device time a call by kernel name), its
   time at every slice size hs it can take beside ``ssd_bwd_plan``'s,
   each call's largest error over its largest gradient entry against
   ``ssd_bwd_plain``; then the backward alone timed in this checkout and
   in each DIR (the root of another checkout, such as the parent's ``git
   archive`` unpacked under ``build/``; without DIRs ``build/parent``
   when it exists), each in its own process importing its own checkout,
   in turns: this, the DIRs, the DIRs in reverse, this; with each, the
   peak memory one call allocates (its outputs and scratch, MB).
5. The RG-LRU's backward (``csrc/rglru_bwd.cu``) at ``chip_smoke.py``'s
   phase-2 rows (recurrentgemma-9b's W 4096: f32 8 × 128, 2 × 1024 with
   dh_final, 1 × 100 with h0 and dh_final, 4 × 1, 2 × 128 saturated with
   dh_final; bf16 8 × 128), on the inputs that script draws: its kernels
   by ``torch.profiler`` (device time and launches a call by kernel
   name) and each call's largest error over its largest gradient entry
   against ``rglru_bwd_plain``; a streaming yardstick, one PyTorch
   elementwise call at 8 × 128 × 4096 f32 (two and three reads, one
   write) timed the same way beside its bytes bound; then the backward
   alone in this checkout and in each DIR in turns, as part 4, each with
   the memory a call allocates (a checkout whose backward refuses bf16
   reports the refusal).

Each timing is one line ``TUNING {json}`` on stdout.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

cs = torch = None    # chip_smoke and torch of the checkout timed: load()

MAMBA = dict(H=64, P=64, G=1, N=128)
W = 4096
LENGTHS = (5, 600, 1100, 2000, 2600)
RGLRU_CHUNKS = (16, 32, 64, 128, 256)


def load(root: Path) -> None:
    """Import torch and ``chip_smoke`` (and so ``repro_torch``) from the
    checkout at ``root``."""
    global cs, torch
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch as torch_
    import chip_smoke as cs_
    cs, torch = cs_, torch_


def emit(**row):
    print("TUNING", json.dumps(row), flush=True)


def main_shapes(flush):
    for S in tuple(range(5, 11)) + LENGTHS[1:]:
        for kernel, case, shape in (
                ("ssd", cs.ssd_case, MAMBA),
                ("rglru", cs.rglru_case, dict(W=W))):
            r = case(f"{kernel}-s{S}", B=1, S=S, dtype=torch.float32,
                     flush=flush, **shape)
            emit(kernel=kernel, S=S, ms=r["ms"], bound_ms=r["bound_ms"],
                 ok=r["ok"])


def chunk_lengths(flush):
    for S in LENGTHS:
        r = cs.ssd_case(f"ssd-s{S}", B=1, S=S, dtype=torch.float32,
                        flush=flush, **MAMBA)
        emit(kernel="ssd", S=S, chunk_len=r["chunk_len"], ms=r["ms"],
             bound_ms=r["bound_ms"], ok=r["ok"])
        for L in RGLRU_CHUNKS + (None,):
            r = cs.rglru_case(f"rglru-s{S}", B=1, S=S, W=W,
                              dtype=torch.float32, flush=flush,
                              chunk_len=L)
            emit(kernel="rglru", S=S, chunk_len=r["chunk_len"],
                 planned=L is None, ms=r["ms"], bound_ms=r["bound_ms"],
                 ok=r["ok"])


def device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        t = getattr(evt, name, None)
        if t:
            return float(t)
    return 0.0


def passes(fn, what, S, calls=10):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if "ssd_" in evt.key or "rglru_" in evt.key:
            emit(kernel=what, S=S, name=evt.key, launches=evt.count // calls,
                 us_per_call=device_us(evt) / calls)


# part 4: the backward's shapes, name -> (B, S, dh_final)
BWD_SHAPES = {"b8-s128": (8, 128, False), "b2-s1024-dh": (2, 1024, True)}
BWD_DTYPES = ("float32", "bfloat16")


def bwd_inputs(B, S, dh, dtype, seed=0):
    """Seeded inputs drawn as ``chip_smoke.ssd_bwd_case`` draws them, and
    the forward kernels' kept states: the backward's arguments."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def z(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    H, P, G, N = (MAMBA[k] for k in ("H", "P", "G", "N"))
    x, dt = z(B, S, H, P).to(dtype), torch.nn.functional.softplus(z(B, S, H))
    A = -torch.exp(z(H) * 0.5)
    Bm, Cm = (z(B, S, G, N) * 0.3).to(dtype), (z(B, S, G, N) * 0.3).to(dtype)
    D = z(H)
    dy = z(B, S, H, P).to(dtype)
    dhf = z(B, H, P, N) if dh else None
    _, _, states, decay = cs.kssd._ssd_cuda(x, dt, A, Bm, Cm, D, None,
                                            keep=True)
    return (x, dt, A, Bm, Cm, D, None, dy, dhf, states, decay)


def call_peak_mb(fn) -> float:
    """The memory one call of ``fn`` allocates on the card (its outputs
    and scratch, MB)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - before) / 1e6


# part 5: the RG-LRU backward's rows, name -> (B, S, use_h0, use_dh,
# saturated, seed, dtype), as chip_smoke.backward_rows draws them
RGLRU_BWD_ROWS = {
    "b8-s128": (8, 128, False, False, False, 0, "float32"),
    "b2-s1024-dh": (2, 1024, False, True, False, 1, "float32"),
    "b1-s100-h0-dh": (1, 100, True, True, False, 2, "float32"),
    "b4-s1": (4, 1, False, False, False, 3, "float32"),
    "b2-s128-saturated-dh": (2, 128, False, True, True, 4, "float32"),
    "b8-s128-bf16": (8, 128, False, False, False, 5, "bfloat16"),
}


def rglru_bwd_inputs(B, S, use_h0, use_dh, saturated, seed, dtype):
    """Seeded inputs drawn as ``chip_smoke.rglru_bwd_case`` draws them,
    and the forward kernels' kept states: the backward's arguments."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def z(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, rg, ig = z(B, S, W), z(B, S, W), z(B, S, W)
    ll = z(W)
    if saturated:
        ll = torch.full((W,), -4.3, device="cuda")
        pick = torch.randint(0, 3, (B, S, W), generator=gen, device="cuda")
        low = torch.tensor([-40.0, -12.0, -10.0], device="cuda")[pick]
        rg = torch.where(torch.rand((B, S, W), generator=gen,
                                    device="cuda") < 0.5, low, rg)
    h0 = z(B, W) * 0.2 if use_h0 else None
    dtype = getattr(torch, dtype)
    dh = z(B, S, W).to(dtype)
    dhf = z(B, W) if use_dh else None
    x, rg, ig = (t.to(dtype) for t in (x, rg, ig))
    _, _, states = cs.krg._rglru_cuda(x, rg, ig, ll, h0, keep=True)
    return (x, rg, ig, ll, h0, dh, dhf, states)


def rglru_bwd_time_here(tag: str) -> None:
    """The RG-LRU backward alone at every part-5 row, in this process's
    checkout."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    card = cs.card_line()
    for name, row in RGLRU_BWD_ROWS.items():
        args = rglru_bwd_inputs(*row)

        def kernel():
            return cs.krg._rglru_bwd_cuda(*args)
        try:
            peak_mb = call_peak_mb(kernel)
        except ValueError as refused:       # an older checkout: f32 only
            emit(part="rglru-bwd-turns", tag=tag, root=str(cs.ROOT),
                 shape=name, dtype=row[-1], ms=None, refused=str(refused),
                 card=card)
            continue
        emit(part="rglru-bwd-turns", tag=tag, root=str(cs.ROOT), shape=name,
             dtype=row[-1], ms=cs.device_ms(kernel, flush),
             call_peak_mb=peak_mb, card=card)


def rglru_bwd_kernels() -> None:
    """Part 5's first half: each row's kernels by ``torch.profiler`` and
    its error against ``rglru_bwd_plain``."""
    card = cs.card_line()
    krg = cs.krg
    for name, row in RGLRU_BWD_ROWS.items():
        args = rglru_bwd_inputs(*row)
        got = krg._rglru_bwd_cuda(*args)
        torch.cuda.synchronize()
        want = krg.rglru_bwd_plain(*args[:7])
        err = max(float((g.float() - w.float()).abs().max())
                  / max(float(w.float().abs().max()), 1e-30)
                  for g, w in zip(got, want))
        calls, per_call = 10, {}
        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(calls):
                krg._rglru_bwd_cuda(*args)
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if "rglru_bwd" in evt.key and device_us(evt):
                kernel = evt.key[evt.key.index("rglru_bwd"):]
                kernel = kernel.split("<")[0].split("(")[0]
                per_call[kernel] = {"launches": evt.count / calls,
                                    "ms": device_us(evt) / 1e3 / calls}
        emit(part="rglru-bwd-kernels", shape=name, dtype=row[-1],
             scaled_err=err, kernels=per_call, card=card)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    a, b, c, d = (torch.randn(8, 128, W, device="cuda") for _ in range(4))
    for name, fn, arrays in (
            ("add", lambda: torch.add(a, b, out=c), 3),
            ("addcmul", lambda: torch.addcmul(a, b, c, out=d), 4)):
        emit(part="streaming", call=name, shape="8x128x4096 f32",
             ms=cs.device_ms(fn, flush),
             bound_ms=arrays * a.numel() * 4 / cs.HBM_BYTES_PER_S * 1e3,
             card=card)


def bwd_time_here(tag: str) -> None:
    """The backward alone at every part-4 shape, in this process's
    checkout."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    card = cs.card_line()
    for name, (B, S, dh) in BWD_SHAPES.items():
        for dt in BWD_DTYPES:
            args = bwd_inputs(B, S, dh, getattr(torch, dt))
            peak_mb = call_peak_mb(lambda: cs.kssd._ssd_bwd_cuda(*args))
            ms = cs.device_ms(lambda: cs.kssd._ssd_bwd_cuda(*args), flush)
            emit(part="bwd-turns", tag=tag, root=str(cs.ROOT), shape=name,
                 dtype=dt, ms=ms, call_peak_mb=peak_mb, card=card)


def bwd_slices_and_passes() -> None:
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    card = cs.card_line()
    kssd = cs.kssd
    for name, (B, S, dh) in BWD_SHAPES.items():
        for dt in BWD_DTYPES:
            args = bwd_inputs(B, S, dh, getattr(torch, dt))
            want = kssd.ssd_bwd_plain(*args[:9])
            H, G = MAMBA["H"], MAMBA["G"]
            planned = kssd.ssd_bwd_plan(B, S, H, G, MAMBA["N"])
            for hs in [d for d in range(1, H // G + 1) if (H // G) % d == 0]:
                def kernel():
                    return kssd._ssd_bwd_cuda(*args, hs=hs)
                got = kernel()
                torch.cuda.synchronize()
                err = max(float((g.float() - w.float()).abs().max())
                          / max(float(w.float().abs().max()), 1e-30)
                          for g, w in zip(got, want) if w is not None)
                emit(part="bwd-slices", shape=name, dtype=dt, hs=hs,
                     planned=hs == planned, scaled_err=err,
                     ms=cs.device_ms(kernel, flush), card=card)
            ms_a_call = {}
            calls = 10
            kssd._ssd_bwd_cuda(*args)
            torch.cuda.synchronize()
            act = [torch.profiler.ProfilerActivity.CPU,
                   torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=act) as prof:
                for _ in range(calls):
                    kssd._ssd_bwd_cuda(*args)
                torch.cuda.synchronize()
            for evt in prof.key_averages():
                if "ssd_bwd_" in evt.key and device_us(evt):
                    kernel = evt.key[evt.key.index("ssd_bwd_"):]
                    kernel = kernel.split("<")[0].split("(")[0]
                    ms_a_call[kernel] = ms_a_call.get(kernel, 0.0) \
                        + device_us(evt) / 1e3 / calls
            emit(part="bwd-passes", shape=name, dtype=dt,
                 ms_a_call=ms_a_call, card=card,
                 plan=kssd.ssd_bwd_launch_plan(B, S, H, G, MAMBA["N"],
                                               getattr(torch, dt)))


def bwd_turns(dirs, which: str = "ssd") -> None:
    me = Path(__file__).resolve()
    order = [ROOT] + list(dirs) + list(reversed(dirs)) + [ROOT]
    for i, root in enumerate(order):
        tag = "this" if root == ROOT else Path(root).name
        proc = subprocess.run([sys.executable, str(me), "--bwd-time-here",
                               str(root), "--tag", f"{tag}#{i}",
                               "--which", which], cwd=root)
        if proc.returncode != 0:
            raise SystemExit(f"timing in {root} failed: {proc.returncode}")


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", action="store_true",
                    help="part 2 only: the passes timed apart")
    ap.add_argument("--main-shapes", action="store_true",
                    help="part 3 only: every main-path S, own chunks")
    ap.add_argument("--bwd", nargs="*", metavar="DIR",
                    help="part 4 only: the SSD backward, in turns against "
                         "these checkouts")
    ap.add_argument("--rglru-bwd", nargs="*", metavar="DIR",
                    help="part 5 only: the RG-LRU backward, in turns "
                         "against these checkouts")
    ap.add_argument("--bwd-time-here", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="", help=argparse.SUPPRESS)
    ap.add_argument("--which", default="ssd", help=argparse.SUPPRESS)
    args = ap.parse_args()
    load(Path(args.bwd_time_here).resolve() if args.bwd_time_here else ROOT)
    if not torch.cuda.is_available():
        print("scan_tuning: no CUDA device", file=sys.stderr)
        return 1
    if args.bwd_time_here:
        if args.which == "rglru":
            cs.kbuild.build_all(["rglru_scan", "rglru_bwd"])
            rglru_bwd_time_here(args.tag)
        else:
            cs.kbuild.build_all(["ssd", "ssd_bwd"])
            bwd_time_here(args.tag)
        return 0
    print(cs.card_line())
    if args.rglru_bwd is not None:
        cs.kbuild.build_all(["rglru_scan", "rglru_bwd"])
        for name, log in cs.kbuild.build_logs.items():
            print(f"--- nvcc {name}.cu ---\n{log.strip()}")
        rglru_bwd_kernels()
        dirs = [Path(d).resolve() for d in args.rglru_bwd]
        if not dirs and (ROOT / "build" / "parent").exists():
            dirs = [ROOT / "build" / "parent"]
        bwd_turns(dirs, "rglru")
        print(cs.card_line())
        return 0
    if args.bwd is not None:
        cs.kbuild.build_all(["ssd", "ssd_bwd"])
        for name, log in cs.kbuild.build_logs.items():
            print(f"--- nvcc {name}.cu ---\n{log.strip()}")
        bwd_slices_and_passes()
        dirs = [Path(d).resolve() for d in args.bwd]
        if not dirs and (ROOT / "build" / "parent").exists():
            dirs = [ROOT / "build" / "parent"]
        bwd_turns(dirs)
        print(cs.card_line())
        return 0
    cs.kbuild.build_all(["ssd", "rglru_scan"])
    for name, log in cs.kbuild.build_logs.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}")
    if args.main_shapes:
        main_shapes(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
        print(cs.card_line())
        return 0
    if not args.passes:
        chunk_lengths(torch.empty(256 << 20, dtype=torch.uint8,
                                  device="cuda"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def z(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    for S in (600, 2600):
        x = z(1, S, 64, 64)
        dt = torch.nn.functional.softplus(z(1, S, 64))
        A = -torch.exp(z(64) * 0.5)
        Bm, Cm = z(1, S, 1, 128) * 0.3, z(1, S, 1, 128) * 0.3
        D = z(64)
        passes(lambda: cs.kssd.ssd(x, dt, A, Bm, Cm, D), "ssd", S)
        xs = [z(1, S, W) for _ in range(3)]
        ll = z(W)
        passes(lambda: cs.krg.rglru(*xs, ll), "rglru", S)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
