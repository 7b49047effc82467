#!/usr/bin/env python3
"""Before and after on one NVIDIA card: the MoE combine and its backward
(with the router's) as one checkout runs them, for two or more
checkouts of the repository, in turns.

    python3 tools/combine_ab.py ROOT_A ROOT_B      # A, B, B, A
    python3 tools/combine_ab.py --one ROOT         # one checkout, once

Each turn runs in its own process, which imports ``repro_torch`` and
``chip_smoke.py`` from that checkout alone and builds its kernels.  At
granite-moe-3b-a800m's E 40, k 8, d 1536 in bf16, on a decode step's 4
tokens and a chunk's 64 (dropless, as serving runs the layer) and on
training's 8 x 128 tokens at capacity factor 1.25 (C 256), with the
routing of the checkout's router kernel on seeded logits, it times by
``chip_smoke.device_ms`` (a CUDA graph, L2 flushed, mean of 20):

- a checkout with ``repro_torch.kernels.moe_combine``: its combine
  kernel (``fwd_ms``) and its backward kernel (``bwd_ms``);
- one without: the eager chain its MoE layer ran (``models/moe.py``:
  a zero row concatenated where the call can drop, an ``index_select``
  of the T·k rows, w cast to bf16, a multiply and a sum; ``fwd_ms``),
  and autograd's backward through it followed by ``router_bwd``'s launch
  on its dw (``bwd_ms``, its forward run once outside the timed region).

It also times each side's host cost (``fwd_host_us``, ``bwd_host_us``:
the median over 50 calls of the host time to put one call on the card,
the card idle at its start and not waited for): the kernels through the
wrappers the MoE layer calls (``moe_combine``, ``moe_combine_bwd``),
the chain as above with autograd's backward and ``router_bwd``.

Each measurement is one line ``COMBINE {json}`` with the card's name and
power limit and the timing floor (one trivial launch in a graph).
"""
from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

E, K, D = 40, 8, 1536
# name, T, capacity factor (None: dropless, C = T)
CASES = (("decode", 4, None), ("chunk", 64, None), ("train", 1024, 1.25))


def emit(**row):
    print("COMBINE", json.dumps(row), flush=True)


def chain_forward(torch, out_buf, w, slot, drops: bool):
    """The eager combine: the zero row only where the call can drop, as
    the MoE layer did."""
    T, k = slot.shape
    if drops:
        out_buf = torch.cat([out_buf, out_buf.new_zeros((1, D))])
    vals = out_buf.index_select(0, slot.reshape(-1)).view(T, k, D)
    return (vals * w[..., None].to(vals.dtype)).sum(1)


def host_us(torch, fn, iters: int = 50) -> float:
    """Median host time of one call of ``fn`` in µs, the card idle at its
    start and not waited for at its end."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return sorted(times)[iters // 2]


def one(root: Path) -> None:
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import torch
    cs.kbuild.build_all(cs.SOURCES)
    has_kernel = importlib.util.find_spec(
        "repro_torch.kernels.moe_combine") is not None
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    common = dict(root=str(root), card=cs.card_line(),
                  timing_floor_ms=cs.timing_floor(flush))
    for name, T, cf in CASES:
        C = T if cf is None else max(int(math.ceil(T * K / E * cf)), 1)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(T)
        logits = torch.randn((T, E), generator=gen, device="cuda")
        out_buf = torch.randn((E * C, D), generator=gen,
                              device="cuda").to(torch.bfloat16)
        dy = torch.randn((T, D), generator=gen,
                         device="cuda").to(torch.bfloat16)
        dps = torch.randn((E,), generator=gen, device="cuda")
        dz = torch.randn((), generator=gen, device="cuda")
        r = cs.kr.router_dispatch(logits, K, n_real=E, capacity=C)
        if has_kernel:
            from repro_torch.kernels import moe_combine as kc
            fwd = cs.device_ms(
                lambda: kc._moe_combine_cuda(out_buf, r.w, r.slot), flush)
            bwd = cs.device_ms(lambda: kc._moe_combine_bwd_cuda(
                dy, out_buf, logits, r.probs, r.idx, r.w, r.slot, r.src, dps,
                dz, n_real=E), flush)
            fwd_host = host_us(torch, lambda: kc.moe_combine(
                out_buf, r.w, r.slot))
            bwd_host = host_us(torch, lambda: kc.moe_combine_bwd(
                dy, out_buf, logits, r.probs, r.idx, r.w, r.slot, r.src, dps,
                dz, n_real=E))
        else:
            drops = cf is not None
            fwd = cs.device_ms(lambda: chain_forward(
                torch, out_buf, r.w, r.slot, drops), flush)
            ob = out_buf.clone().requires_grad_()
            w = r.w.clone().requires_grad_()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                y = chain_forward(torch, ob, w, r.slot, drops)

            def backward():
                d_ob, dw = torch.autograd.grad(y, (ob, w), dy,
                                               retain_graph=True)
                return d_ob, cs.kr._router_bwd_cuda(
                    logits, r.probs, r.idx, r.w, dw, dps, dz, n_real=E)
            bwd = cs.device_ms(backward, flush, stream=side)
            fwd_host = host_us(torch, lambda: chain_forward(
                torch, out_buf, r.w, r.slot, drops))
            with torch.cuda.stream(side):
                bwd_host = host_us(torch, backward)
        emit(case=name, T=T, C=C, what="kernels" if has_kernel else "chain",
             fwd_ms=fwd, bwd_ms=bwd, fwd_host_us=fwd_host,
             bwd_host_us=bwd_host, **common)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        one(Path(argv[1]).resolve())
        return 0
    roots = [Path(a).resolve() for a in argv]
    if len(roots) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)],
                              cwd=root)
        if proc.returncode != 0:
            print(f"combine_ab: {root} failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
