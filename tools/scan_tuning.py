#!/usr/bin/env python3
"""Time the SSD's and the RG-LRU's chunk lengths on one NVIDIA card.

    python3 tools/scan_tuning.py               # parts 1 and 2
    python3 tools/scan_tuning.py --passes      # part 2 only
    python3 tools/scan_tuning.py --main-shapes # part 3 only

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

Each timing is one line ``TUNING {json}`` on stdout.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

MAMBA = dict(H=64, P=64, G=1, N=128)
W = 4096
LENGTHS = (5, 600, 1100, 2000, 2600)
RGLRU_CHUNKS = (16, 32, 64, 128, 256)


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


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--passes", action="store_true",
                    help="part 2 only: the passes timed apart")
    ap.add_argument("--main-shapes", action="store_true",
                    help="part 3 only: every main-path S, own chunks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_tuning: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line())
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
