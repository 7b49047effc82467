#!/usr/bin/env python3
"""Time the bf16 attention kernel's tuning choices on one NVIDIA card.

    python3 tools/attention_tuning.py             # both parts
    python3 tools/attention_tuning.py --splits    # part 1 only
    python3 tools/attention_tuning.py --variants  # part 2 only

1. Key splits: ``chip_smoke.py``'s attention check (the kernel against
   its plain version, timed in a CUDA graph with the L2 flushed, beside
   SDPA and the bound) on the main paths' bf16 shapes at forced
   ``n_split`` and at ``plan``'s.
2. Source variants: the checkout's ``src/``, ``chip_smoke.py`` and this
   script copied into ``build/tuning/<variant>`` (listed in
   ``.gitignore``) with one design choice of ``csrc/flash_attention.cu``
   undone, each timed on the same shapes at ``plan``'s splits, in turns:
   as is, the variants, the variants in reverse, as is.

Each timing is one line ``TUNING {json}`` on stdout.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KERNEL = "src/repro_torch/kernels/csrc/flash_attention.cu"
WRAPPER = "src/repro_torch/kernels/attention.py"
# name -> (file, text as is, text of the variant)
VARIANTS = {
    # decode's 16-row blocks whose warps split each key tile, off: every
    # block has 64 rows, of which decode fills one warp's 16 or fewer
    "no-warp-split": [(KERNEL, "if (p.S * p.G <= 16) return",
                       "if (false) return")],
    # row tiles in grid order instead of last (longest under causal) first
    "forward-rows": [(KERNEL, "(gridDim.x - 1 - blockIdx.x) * MR",
                      "blockIdx.x * MR")],
    # 64-key tiles at head_dim 256 for 64-row blocks (32 as is)
    "d256-64-key-tiles": [
        (KERNEL, "launch_tc_tiles<256, WS ? 64 : 32, WS>",
         "launch_tc_tiles<256, 64, WS>"),
        (WRAPPER, "return 32 if D > 128 and rows > FRAG_ROWS else 64",
         "return 64")],
}

QWEN = dict(Hq=16, Hkv=16, D=64)
GRANITE = dict(Hq=24, Hkv=8, D=64)
RGEMMA = dict(Hq=16, Hkv=1, D=256, window=2048)
# name -> (shape, forced key splits of part 1)
CASES = {
    "qwen-decode-b8-t1024": (dict(QWEN, B=8, S=1, T=1024, offsets=[
        0, 77, 191, 300, 451, 612, 850, 1023]), [1, 2, 4, 8]),
    "qwen-decode-b4-t1024": (dict(QWEN, B=4, S=1, T=1024, offsets=[
        3, 400, 777, 1023]), [1, 2, 4, 8]),
    "granite-decode-b4-t1024": (dict(GRANITE, B=4, S=1, T=1024, offsets=[
        3, 400, 777, 1023]), [1, 3, 8, 16]),
    "rgemma-decode-b4-t3072": (dict(RGEMMA, B=4, S=1, T=3072, offsets=[
        600, 1100, 2000, 2600]), [8, 16, 24, 33, 48]),
    "qwen-chunk": (dict(QWEN, B=1, S=64, T=1024, offsets=[320]),
                   [1, 4, 8, 16]),
    "granite-chunk": (dict(GRANITE, B=1, S=64, T=1024, offsets=[400]),
                      [1, 3, 6, 12]),
    "qwen-prefill-s384": (dict(QWEN, B=1, S=384, T=384), [1, 2]),
    "rgemma-prefill-s600": (dict(RGEMMA, B=1, S=600, T=600), [1, 2]),
    "rgemma-prefill-s1100": (dict(RGEMMA, B=1, S=1100, T=1100), [1, 2]),
    "rgemma-prefill-s2000": (dict(RGEMMA, B=1, S=2000, T=2000), []),
    "rgemma-prefill-s2600": (dict(RGEMMA, B=1, S=2600, T=2600), []),
    # the demo's prompts, a few µs over the timing floor: repeated by the
    # turns of part 2
    **{f"rgemma-prefill-s{S}": (dict(RGEMMA, B=1, S=S, T=S), [])
       for S in range(5, 11)},
}


def time_cases(tag: str, forced: bool) -> None:
    """Part 1 (``forced``: every split count of CASES and plan's) or one
    variant's turn of part 2 (plan's alone), timed in this process."""
    import torch

    import chip_smoke as cs
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for name, (shape, splits) in CASES.items():
        for n in (splits if forced else []) + [None]:
            r = cs.attention_case(name, dtype=torch.bfloat16, flush=flush,
                                  n_split=n, **shape)
            cs.check(r["ok"], f"{tag} {name} n_split {n}: {r}")
            print("TUNING", json.dumps(dict(
                {k: r[k] for k in ("case", "shape", "n_split", "ms",
                                   "library_ms", "bound_ms")},
                variant=tag, forced=n is not None)), flush=True)


def make_variant(name: str) -> Path:
    dst = ROOT / "build" / "tuning" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    (dst / "tools").mkdir()
    shutil.copy(Path(__file__), dst / "tools" / Path(__file__).name)
    for rel, old, new in VARIANTS[name]:
        path = dst / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} not once in {rel}")
        path.write_text(text.replace(old, new))
    return dst


def run_variants() -> None:
    roots = {"as-is": ROOT}
    roots.update((name, make_variant(name)) for name in VARIANTS)
    order = list(roots) + list(reversed(roots))
    for name in order:
        script = roots[name] / "tools" / Path(__file__).name
        subprocess.run([sys.executable, str(script), "--turn", name],
                       check=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--splits", action="store_true", help="part 1 only")
    ap.add_argument("--variants", action="store_true", help="part 2 only")
    ap.add_argument("--turn", help=argparse.SUPPRESS)  # one variant's turn
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("attention_tuning: no CUDA device", file=sys.stderr)
        return 1
    if args.turn:
        time_cases(args.turn, forced=False)
        return 0
    if not args.variants:
        time_cases("as-is", forced=True)
    if not args.splits:
        run_variants()
    return 0


if __name__ == "__main__":
    sys.exit(main())
