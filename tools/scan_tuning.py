#!/usr/bin/env python3
"""Time the SSD's and the RG-LRU's chunk lengths on one NVIDIA card.

    python3 tools/scan_tuning.py               # parts 1 and 2
    python3 tools/scan_tuning.py --passes      # part 2 only
    python3 tools/scan_tuning.py --main-shapes # part 3 only
    python3 tools/scan_tuning.py --bwd [DIR ...] # part 4 only

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


def bwd_time_here(tag: str) -> None:
    """The backward alone at every part-4 shape, in this process's
    checkout."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    card = cs.card_line()
    for name, (B, S, dh) in BWD_SHAPES.items():
        for dt in BWD_DTYPES:
            args = bwd_inputs(B, S, dh, getattr(torch, dt))
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = cs.kssd._ssd_bwd_cuda(*args)
            torch.cuda.synchronize()
            peak_mb = (torch.cuda.max_memory_allocated() - before) / 1e6
            del out
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


def bwd_turns(dirs) -> None:
    me = Path(__file__).resolve()
    order = [ROOT] + list(dirs) + list(reversed(dirs)) + [ROOT]
    for i, root in enumerate(order):
        tag = "this" if root == ROOT else Path(root).name
        proc = subprocess.run([sys.executable, str(me), "--bwd-time-here",
                               str(root), "--tag", f"{tag}#{i}"], cwd=root)
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
    ap.add_argument("--bwd-time-here", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    load(Path(args.bwd_time_here).resolve() if args.bwd_time_here else ROOT)
    if not torch.cuda.is_available():
        print("scan_tuning: no CUDA device", file=sys.stderr)
        return 1
    if args.bwd_time_here:
        cs.kbuild.build_all(["ssd", "ssd_bwd"])
        bwd_time_here(args.tag)
        return 0
    print(cs.card_line())
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
