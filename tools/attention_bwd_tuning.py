#!/usr/bin/env python3
"""Time the attention backward (B1-bwd) on one NVIDIA card.

    python3 tools/attention_bwd_tuning.py                 # parts 1 and 2
    python3 tools/attention_bwd_tuning.py --splits        # part 1 only
    python3 tools/attention_bwd_tuning.py --turns DIR ... # part 2 only
    python3 tools/attention_bwd_tuning.py --variants      # part 3 only
    python3 tools/attention_bwd_tuning.py --profile       # part 4 only

1. Row splits: the bf16 backward at the training shapes with its dK/dV
   rows forced into 1-16 splits beside ``bwd_plan``'s count, each call's
   largest error over its largest gradient entry against the plain
   backward beside its time (CUDA graph, L2 flushed, ``chip_smoke``'s
   ``device_ms``).
2. Turns: the backward alone at every training shape, timed in this
   checkout and in each DIR (the root of another checkout, such as the
   parent's ``git archive`` unpacked under ``build/``), each in its own
   process importing its own checkout's ``src/`` and ``chip_smoke.py``,
   in turns: this, the DIRs, the DIRs in reverse, this.  Without DIRs,
   ``build/parent`` when it exists.
3. Variants: copies of this checkout under ``build/tuning/<variant>``
   (listed in ``.gitignore``) with one tile choice of
   ``csrc/flash_attention_bwd.cu`` undone (``VARIANTS``), timed in turns
   as part 2 does.
4. Profile: each training shape's backward under ``torch.profiler``, the
   device time of each of its kernels (``attn_bwd_dq_tc``,
   ``attn_bwd_dkdv_tc``, ``attn_bwd_dkdv_reduce``) a call.

Each timing is one line ``TUNING {json}`` on stdout, with the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
# name -> [(file, text as is, text of the variant)]
VARIANTS = {
    # dQ's key tile: 32 keys at head_dim 256 (16 as is), 64 at 64 (32)
    "dq-d256-32-keys": [(KERNEL, "launch_tc_bwd<256, 16>(p, stream)",
                         "launch_tc_bwd<256, 32>(p, stream)")],
    "dq-d64-64-keys": [(KERNEL, "launch_tc_bwd<64, 32>(p, stream)",
                        "launch_tc_bwd<64, 64>(p, stream)")],
    # one dK/dV block an SM at head_dim 64 (two as is, registers capped)
    "dkdv-d64-1-block": [(KERNEL, "__launch_bounds__(kDkdvThreads, "
                          "D <= 64 ? 2 : 1)",
                          "__launch_bounds__(kDkdvThreads, 1)")],
    # four dQ blocks an SM at head_dim 64 (registers capped at 128)
    "dq-d64-4-blocks": [(KERNEL, "__launch_bounds__(kDqThreads) attn_bwd_dq",
                         "__launch_bounds__(kDqThreads, D <= 64 ? 4 : 1) "
                         "attn_bwd_dq")],
}

# the training shapes: name -> (B, S, T, Hq, Hkv, D, masks)
SHAPES = {
    "qwen-b8-s128": (8, 128, 128, 16, 16, 64, {}),
    "qwen-b4-s1024": (4, 1024, 1024, 16, 16, 64, {}),
    "seamless-encoder-b8-s512": (8, 512, 512, 16, 16, 64,
                                 dict(causal=False)),
    "seamless-cross-b8-s128-t512": (8, 128, 512, 16, 16, 64,
                                    dict(causal=False)),
    "paligemma-prefix-b8-s384": (8, 384, 384, 8, 1, 256,
                                 dict(prefix_len=256)),
    "recurrentgemma-b8-s128": (8, 128, 128, 16, 1, 256, dict(window=2048)),
    "recurrentgemma-b1-s4096": (1, 4096, 4096, 16, 1, 256,
                                dict(window=2048)),
}
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def emit(card: str, **row) -> None:
    print("TUNING", json.dumps(dict(row, card=card)), flush=True)


def inputs(torch, fa, shape, seed=0):
    """Seeded bf16 q, k, v, dO and the forward kernel's o and lse."""
    B, S, T, Hq, Hkv, D, masks = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn(s, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for s in ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D),
                             (B, S, Hq, D)))
    kw = dict(dict(causal=True, window=0, softcap=0.0, prefix_len=None),
              **masks)
    o, lse = fa._attention_cuda(q, k, v, with_lse=True, **kw)
    return q, k, v, o, lse, do, kw


def setup(root: Path):
    """(torch, chip_smoke, the attention module, the card's line, an
    L2-flush buffer) of the checkout at ``root``, its kernels built."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import attention as fa
    from repro_torch.kernels import build
    build.build_all(["flash_attention", "flash_attention_bwd"])
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    return torch, cs, fa, cs.card_line(), flush


def time_here(root: Path, tag: str) -> None:
    """Part 2's timing in one process: the backward of the checkout at
    ``root`` at every shape."""
    torch, cs, fa, card, flush = setup(root)
    for name, shape in SHAPES.items():
        q, k, v, o, lse, do, kw = inputs(torch, fa, shape)
        ms = cs.device_ms(lambda: fa._attention_bwd_cuda(
            q, k, v, o, lse, do, **kw), flush)
        emit(card, part="turns", tag=tag, root=str(root), shape=name, ms=ms)


def run_turns(dirs) -> None:
    me = Path(__file__).resolve()
    order = [ROOT] + list(dirs) + list(reversed(dirs)) + [ROOT]
    for i, root in enumerate(order):
        tag = "this" if root == ROOT else Path(root).name
        proc = subprocess.run([sys.executable, str(me), "--time-here",
                               str(root), "--tag", f"{tag}#{i}"], cwd=root)
        if proc.returncode != 0:
            raise SystemExit(f"timing in {root} failed: {proc.returncode}")


def run_splits() -> None:
    torch, cs, fa, card, flush = setup(ROOT)
    for name, shape in SHAPES.items():
        q, k, v, o, lse, do, kw = inputs(torch, fa, shape)
        want = fa.attention_bwd_plain(q, k, v, o, lse, do, **kw)
        planned = fa.bwd_plan(*shape[:6], torch.bfloat16)[1]
        for n_split in sorted(set(SPLITS) | {planned}):
            def kernel():
                return fa._attention_bwd_cuda(q, k, v, o, lse, do,
                                              n_split=n_split, **kw)
            got = kernel()
            torch.cuda.synchronize()
            err = max(float((g.float() - w.float()).abs().max())
                      / max(float(w.float().abs().max()), 1e-30)
                      for g, w in zip(got, want))
            emit(card, part="splits", shape=name, n_split=n_split,
                 planned=n_split == planned, scaled_err=err,
                 ms=cs.device_ms(kernel, flush))


def run_profile() -> None:
    torch, cs, fa, card, _ = setup(ROOT)
    calls = 5
    for name, shape in SHAPES.items():
        q, k, v, o, lse, do, kw = inputs(torch, fa, shape)
        fa._attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(calls):
                fa._attention_bwd_cuda(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
        by_kernel = {}
        for ev in prof.key_averages():
            dev = getattr(ev, "device_time_total", None)
            if dev is None:
                dev = getattr(ev, "cuda_time_total", 0.0)
            if dev and "attn_bwd" in ev.key:
                kernel = re.split(r"[<(]",
                                  ev.key[ev.key.index("attn_bwd"):])[0]
                by_kernel[kernel] = by_kernel.get(kernel, 0.0) \
                    + dev / 1e3 / calls
        emit(card, part="profile", shape=name, ms_a_call=by_kernel,
             n_split=fa.bwd_plan(*shape[:6], torch.bfloat16)[1])


def make_variant(name: str) -> Path:
    dst = ROOT / "build" / "tuning" / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    for rel, before, after in VARIANTS[name]:
        path = dst / rel
        text = path.read_text()
        if text.count(before) != 1:
            raise SystemExit(f"variant {name}: {before!r} not found once "
                             f"in {rel}")
        path.write_text(text.replace(before, after))
    return dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--splits", action="store_true", help="part 1 only")
    ap.add_argument("--turns", nargs="*", metavar="DIR",
                    help="part 2 only, against these checkouts")
    ap.add_argument("--variants", action="store_true", help="part 3 only")
    ap.add_argument("--profile", action="store_true", help="part 4 only")
    ap.add_argument("--time-here", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.time_here:
        time_here(Path(args.time_here).resolve(), args.tag)
        return 0
    everything = not (args.splits or args.turns is not None
                      or args.variants or args.profile)
    if args.splits or everything:
        run_splits()
    if args.turns is not None or everything:
        dirs = [Path(d).resolve() for d in (args.turns or [])]
        if not dirs and (ROOT / "build" / "parent").exists():
            dirs = [ROOT / "build" / "parent"]
        run_turns(dirs)
    if args.variants:
        run_turns([make_variant(name) for name in VARIANTS])
    if args.profile:
        run_profile()
    return 0


if __name__ == "__main__":
    sys.exit(main())
