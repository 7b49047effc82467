#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                   # everything, as below
    python3 chip_smoke.py --kernels-only    # phases 1-2

Phases, in order; any failure exits non-zero:

1. Card and build: the card's name and power limit, then ``nvcc`` builds
   every kernel from ``src/repro_torch/kernels/csrc`` (``-Xptxas -v``
   output printed: registers, shared memory, spills).
2. Each kernel against its plain PyTorch version on the card, on random
   inputs: qwen1.5-0.5b attention at a 384-token prefill, a chunk at an
   offset and (B,) decode, at the launcher demo's short prompts and
   4-slot decode, and the reference's ATTN_SWEEP, in bf16 and f32 (f32
   with TF32 off), with the kernel's, the plain version's and one library
   call's times (CUDA events, warmed up, L2 flushed) beside the least
   time the card could take (the bound).
3. Full-width qwen1.5-0.5b served through the port's launcher
   (``launch.serve --demo``: tcp ``Engine`` + ``ServingGateway``, six
   prompts through ``gen.submit`` / ``gen.result``).
4. Sessions: chunked prefill (64 tokens), ``session_cap=4``,
   ``max_len=1024``; two conversations of three ~384-token turns through
   ``gen.generate`` with a ``session_id``.  Phases 3 and 4 are the main
   path: kernel launch counts are zeroed before them and read after, and
   every (entry point, shape) the kernel was launched at is recorded with
   the inputs of its last launch.
5. The main path's own shapes: the kernel against its plain version on
   those recorded inputs, timed and bounded as in phase 2.  These rows,
   with the main path's launch counts, make the kernels' JSON summary.
6. Full-width parity: f32 compute, TF32 off; prefill and 8 decode steps
   through the kernel against the same through the plain version.

The last two lines of stdout are the kernels' JSON summary and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.executor import Engine  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import attention as attn_layer  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.services import ServingGateway  # noqa: E402

ARCH = "qwen1.5-0.5b"
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,  # dense bf16 tensor cores
                  torch.float32: 67e12}    # f32 outside the tensor cores
TOL = {torch.bfloat16: 2e-2,
       # looser than the CPU's 2e-5: the kernel sums in another order
       torch.float32: 1e-4}
# Also per output row (one query, one head): its largest error over its
# largest |value|.  Rows over long keys average to small values (~0.05
# at T=1024), under which a wrong tile could hide in bf16's absolute
# limit; rounding the output to bf16 alone costs at most 2^-7 here.
ROW_TOL = 2e-2
PARITY_TOL = 2e-3   # full-width logits, f32, 24 layers
# tests/test_kernels.py's ATTN_SWEEP (tests/test_torch_isolation.py keeps
# the two equal): S, T, Hq, Hkv, D, causal, window, softcap, prefix, dtype
ATTN_SWEEP = [
    (64, 64, 4, 2, 16, True, 0, 0.0, None, "float32"),
    (128, 128, 4, 4, 32, True, 32, 0.0, None, "float32"),
    (96, 96, 8, 1, 64, True, 0, 30.0, None, "float32"),
    (80, 80, 4, 2, 16, True, 0, 0.0, 24, "float32"),
    (200, 200, 2, 2, 16, True, 0, 0.0, None, "float32"),
    (64, 64, 2, 2, 16, False, 0, 0.0, None, "float32"),
    (128, 128, 4, 2, 32, True, 0, 0.0, None, "bfloat16"),
]


class PhaseError(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise PhaseError(what)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------
def device_ms(fn, flush, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms: captured once in a CUDA graph
    (no host launch overhead in the window), replayed ``iters`` times,
    each replay timed by CUDA events with the L2 cache flushed first (by
    writing ``flush``, a buffer larger than the L2)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def visible(S: int, T: int, offsets, causal: bool, window: int, prefix,
            device="cpu") -> torch.Tensor:
    """(B, S, T) mask of the (query, key) pairs the masks leave visible."""
    qpos = torch.tensor(offsets, device=device)[:, None, None] + \
        torch.arange(S, device=device)[None, :, None]
    kpos = torch.arange(T, device=device)[None, None, :]
    m = torch.ones(len(offsets), S, T, dtype=torch.bool, device=device)
    if causal:
        cm = kpos <= qpos
        if prefix is not None:
            cm = cm | (kpos < prefix)
        m = m & cm
    if window > 0:
        m = m & (kpos > qpos - window)
    return m


def bound_ms(q, k, offsets, causal, window, prefix):
    """The least time the card could take: bytes (q read, the K/V rows
    some query can see read once, the output written) over 3.35 TB/s, or
    operations (2·D multiply-adds per visible pair, for Q·Kᵀ and P·V)
    over the dtype's peak, whichever is larger; counted for this run's
    offsets."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    elt = q.element_size()
    kv_rows = 0
    for off in offsets:
        last = T if not causal else min(T, max(off + S, prefix or 0))
        first = max(0, off - window + 1) if window > 0 else 0
        kv_rows += max(last - first, 0)
    nbytes = 2 * q.numel() * elt + 2 * kv_rows * Hkv * D * elt
    pairs = int(visible(S, T, offsets, causal, window, prefix).sum())
    ops = 4 * D * Hq * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_ms(q, k, v, offsets, causal, window, prefix, flush):
    """``scaled_dot_product_attention`` on the same inputs and masks, as a
    yardstick only (the port never calls it)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if Hq != Hkv:
        kt = kt.repeat_interleave(Hq // Hkv, dim=1)
        vt = vt.repeat_interleave(Hq // Hkv, dim=1)
    mask = visible(S, T, offsets, causal, window, prefix, "cuda")[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return device_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), flush)


def offsets_of(q_offset, B: int):
    if isinstance(q_offset, torch.Tensor):
        off = q_offset.reshape(-1).tolist()
        return off * B if len(off) == 1 else off
    return [int(q_offset)] * B


# ---------------------------------------------------------------------------
# phases 2 and 5: kernel against its plain version
# ---------------------------------------------------------------------------
def check_kernel(name, q, k, v, kw, flush=None):
    """Kernel against plain on one set of inputs; with ``flush`` (an
    L2-sized buffer) also the times and the bound."""
    B, S = q.shape[:2]
    T = k.shape[1]
    got = fa.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = fa.attention_plain(q, k, v, **kw).float()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    row_err = float((diff.amax(-1)
                     / want.abs().amax(-1).clamp_min(1e-3)).max())
    row = {"case": name, "shape": f"B{B} S{S} T{T}",
           "dtype": str(q.dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": TOL[q.dtype], "row_rel_err": row_err,
           "row_tol": ROW_TOL,
           "ok": err <= TOL[q.dtype] and row_err <= ROW_TOL}
    if flush is not None:
        offsets = offsets_of(kw["q_offset"], B)
        masks = (kw.get("causal", True), kw.get("window", 0),
                 kw.get("prefix_len"))
        row["ms"] = device_ms(lambda: fa.attention(q, k, v, **kw), flush)
        row["plain_ms"] = device_ms(
            lambda: fa.attention_plain(q, k, v, **kw), flush)
        row["library_ms"] = sdpa_ms(q, k, v, offsets, *masks, flush)
        row["bound_ms"], row["bound_by"] = bound_ms(q, k, offsets, *masks)
    print("kernel-check", json.dumps(row))
    return row


def attention_case(name, B, S, T, Hq, Hkv, D, dtype, *, causal=True,
                   window=0, softcap=0.0, prefix=None, offsets=None,
                   flush=None, seed=0):
    """``check_kernel`` on seeded random inputs of one shape."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v = rnd(B, S, Hq, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
    offsets = [0] * B if offsets is None else list(offsets)
    off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=off,
              prefix_len=prefix)
    return check_kernel(name, q, k, v, kw, flush)


QWEN = dict(Hq=16, Hkv=16, D=64)      # qwen1.5-0.5b attention heads
MAIN_CASES = {
    "prefill": dict(B=1, S=384, T=384),
    "chunk": dict(B=1, S=64, T=1024, offsets=[320]),
    "decode": dict(B=8, S=1, T=1024,
                   offsets=[0, 77, 191, 300, 451, 612, 850, 1023]),
    # the launcher demo's: prompts of 5-10 tokens prefilled whole (T = S,
    # one query row per block), decode over its 4 slots of 128
    "prefill-s5": dict(B=1, S=5, T=5),
    "prefill-s10": dict(B=1, S=10, T=10),
    "prefill-s16": dict(B=1, S=16, T=16),
    "decode-b4-t128": dict(B=4, S=1, T=128, offsets=[0, 41, 90, 127]),
    # the session phase's: 4 slots of 1024
    "decode-b4-t1024": dict(B=4, S=1, T=1024, offsets=[3, 400, 777, 1023]),
}


def assert_all_ok(rows):
    bad = [f"{r['case']}/{r['dtype']}: {r['max_abs_err']:.3g} "
           f"(row {r['row_rel_err']:.3g})" for r in rows if not r["ok"]]
    check(not bad, f"kernel disagrees with its plain version: {bad}")


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("f32 cases run with TF32 off (cuda.matmul and cudnn)")
    rows = []
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for name, shape in MAIN_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(attention_case(name, dtype=dtype, flush=flush,
                                       **QWEN, **shape))
    del flush
    for i, case in enumerate(ATTN_SWEEP):
        S, T, Hq, Hkv, D, causal, window, softcap, prefix, _ = case
        Sc = min(24, S // 2)
        kw = dict(Hq=Hq, Hkv=Hkv, D=D, causal=causal, window=window,
                  softcap=softcap, prefix=prefix)
        for dtype in (torch.bfloat16, torch.float32):
            rows.append(attention_case(f"sweep{i}", B=2, S=S, T=T,
                                       dtype=dtype, **kw))
            rows.append(attention_case(
                f"sweep{i}-chunk", B=2, S=Sc, T=T, dtype=dtype,
                offsets=[(T - Sc) // 2] * 2, **kw))
            rows.append(attention_case(
                f"sweep{i}-decode", B=3, S=1, T=T, dtype=dtype,
                offsets=[0, T // 2, T - 1], **kw))
    assert_all_ok(rows)


# ---------------------------------------------------------------------------
# phases 3-4: the main path
# ---------------------------------------------------------------------------
class MainPathRecorder:
    """What the main path gives the kernel.  Wraps the Model entry points
    (to know which of prefill, chunk or decode is running) and the
    attention the layers call; for each (entry point, shape) keeps the
    launches the kernel's wrapper counted (the wrapper alone counts) and
    a copy of the inputs of the last launch."""

    ENTRIES = {"prefill": "prefill", "prefill_chunk": "chunk",
               "decode_step": "decode"}

    def __init__(self):
        self.kind = "outside an entry point"
        self.seen = {}
        self._orig = {}

    def install(self):
        for entry, kind in self.ENTRIES.items():
            orig = self._orig[entry] = getattr(Model, entry)

            def entered(*a, _orig=orig, _kind=kind, **kw):
                outer, self.kind = self.kind, _kind
                try:
                    return _orig(*a, **kw)
                finally:
                    self.kind = outer
            setattr(Model, entry, entered)
        attn_layer.attention = self._attention

    def uninstall(self):
        for entry, orig in self._orig.items():
            setattr(Model, entry, orig)
        attn_layer.attention = fa.attention

    def _attention(self, q, k, v, **kw):
        before = fa.attention.launches
        out = fa.attention(q, k, v, **kw)
        B, S, Hq, D = q.shape
        key = (self.kind, B, S, k.shape[1], Hq, k.shape[2], D, q.dtype)
        rec = self.seen.setdefault(key, {"launches": 0})
        rec["launches"] += fa.attention.launches - before
        # an int offset kept as a 0-d device tensor: the same function,
        # and no host-to-device copy when the copy is timed in a graph
        off = torch.as_tensor(kw["q_offset"], device=q.device).clone()
        rec["inputs"] = (q.clone(), k.clone(), v.clone(),
                         dict(kw, q_offset=off))
        return out

    def by_kind(self):
        n = {kind: 0 for kind in self.ENTRIES.values()}
        for key, rec in self.seen.items():
            n[key[0]] = n.get(key[0], 0) + rec["launches"]
        return n


def phase_demo(cfg):
    t0 = time.monotonic()
    outs, stats = serve_launcher.main(["--arch", ARCH, "--demo"])
    print(f"demo: {len(outs)} requests in {time.monotonic() - t0:.2f}s")
    check(len(outs) == 6, "demo: expected 6 results")
    check(stats["admitted"] == 6 and stats["shed"] == 0,
          f"demo: admission {stats}")
    for o in outs:
        check(o["done"] and len(o["tokens"]) == 12,
              f"demo: unfinished request {o}")
        check(all(0 <= t < cfg.vocab for t in o["tokens"]),
              f"demo: token out of vocab {o['tokens']}")


def phase_sessions(cfg):
    model = Model(cfg)
    params = model.init(1, device="cuda")
    serve = ServeEngine(model, params, max_len=1024, n_slots=4,
                        chunk_tokens=64, session_cap=4, device="cuda")
    rng = np.random.default_rng(1)
    server = Engine("tcp://127.0.0.1:0")
    gw = ServingGateway(server, serve)
    try:
        with Engine("tcp://127.0.0.1:0") as client:
            prompts = {sid: rng.integers(1, cfg.vocab, size=384)
                       for sid in ("conv-a", "conv-b")}
            t0 = time.monotonic()
            n_tok = 0
            for turn in range(3):
                for sid in prompts:
                    out = client.call(server.uri, "gen.generate",
                                      {"tokens": prompts[sid].tolist(),
                                       "max_new": 8, "session_id": sid},
                                      timeout=300.0)
                    check(out["done"] and len(out["tokens"]) == 8,
                          f"sessions: {sid} turn {turn}: {out}")
                    n_tok += len(out["tokens"])
                    prompts[sid] = np.concatenate([
                        prompts[sid], out["tokens"],
                        rng.integers(1, cfg.vocab, size=16)])
            dt = time.monotonic() - t0
            stats = client.call(server.uri, "gen.stats", {})
    finally:
        gw.stop()
        server.shutdown()
    print(f"sessions: 6 turns, {n_tok} tokens in {dt:.2f}s; prefix_hits "
          f"{stats['prefix_hits']} misses {stats['prefix_misses']} saved "
          f"{stats['prefix_tokens_saved']}")
    check(stats["prefix_hits"] >= 2, f"sessions: prefix hits {stats}")


def phase_main_shapes(recorder):
    """The kernel against plain, timed and bounded, on the inputs of the
    last launch of each (entry point, shape) of the main path."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for key in sorted(recorder.seen, key=lambda k: k[:7]):
        rec = recorder.seen[key]
        q, k, v, kw = rec.pop("inputs")
        row = check_kernel(f"main:{key[0]}", q, k, v, kw, flush)
        row["launches"] = rec["launches"]
        rows.append(row)
    del flush
    assert_all_ok(rows)
    return rows


# ---------------------------------------------------------------------------
# phase 6: full-width parity, kernel vs plain
# ---------------------------------------------------------------------------
def phase_parity(cfg):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg.replace(compute_dtype="float32")
    model = Model(cfg)
    params = model.init(2, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    B, S, steps = 2, 128, 8
    toks = torch.randint(1, cfg.vocab, (B, S + steps), generator=gen,
                         device="cuda")

    def run():
        logits, cache = model.prefill(params, toks[:, :S],
                                      cache_len=S + steps)
        out = [logits]
        for i in range(steps):
            pos = torch.full((B,), S + i, dtype=torch.int32, device="cuda")
            logits, cache = model.decode_step(params, cache,
                                              toks[:, S + i:S + i + 1], pos)
            out.append(logits)
        return torch.stack(out)

    before = fa.attention.launches
    got = run()
    check(fa.attention.launches - before == cfg.n_layers * (1 + steps),
          "parity: the kernel path did not launch once per layer and call")
    attn_layer.attention = fa.attention_plain
    try:
        want = run()
    finally:
        attn_layer.attention = fa.attention
    check(bool(torch.isfinite(got).all()), "parity: non-finite logits")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"parity: f32 full width, TF32 off, prefill + {steps} decode "
          f"steps: max |kernel - plain| = {err:.3g} (max |logit| "
          f"{scale:.3g}, tolerance {PARITY_TOL} * (1 + |logit|))")
    check(err <= PARITY_TOL * (1 + scale), "parity: logits disagree")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-2 only: build, check and time the "
                         "kernels (no serving, no final ok line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    kbuild.build("flash_attention")
    print(f"build: {time.monotonic() - t0:.1f}s")
    for name, log in kbuild.build_logs.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}")

    phase_kernels()
    if args.kernels_only:
        return 0

    cfg = configs.get(ARCH)
    recorder = MainPathRecorder()
    recorder.install()
    fa.attention.launches = 0
    try:
        phase_demo(cfg)
        phase_sessions(cfg)
    finally:
        recorder.uninstall()
    launches = fa.attention.launches
    by_kind = recorder.by_kind()
    print(f"main path: {launches} kernel launches, by entry point "
          f"{by_kind}")
    check(sum(by_kind.values()) == launches and set(by_kind)
          == set(MainPathRecorder.ENTRIES.values()),
          f"main path: launches outside the Model entry points {by_kind}")
    check(all(n > 0 for n in by_kind.values()),
          f"main path: the kernel was not launched on every entry point "
          f"{by_kind}")
    main_rows = phase_main_shapes(recorder)

    phase_parity(cfg)

    kernels = [{
        "name": f"flash_attention:{r['case'][5:]} {r['shape']}",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96",
        "launches": r["launches"],
        # the same number under the chip summary's key and the issue's
        "max_abs_err": r["max_abs_err"], "max_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"]} for r in main_rows]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
