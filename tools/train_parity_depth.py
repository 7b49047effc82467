#!/usr/bin/env python3
"""How far f32 training gradients of mamba2-1.3b part with depth, on one
NVIDIA card.

    python3 tools/train_parity_depth.py

Full-width mamba2-1.3b in f32 compute with TF32 off, cut to 2, 4, 8, 16
and 48 layers, seeded weights and one 2 x 128 batch.  Each depth's loss
and gradients by ``train.step.loss_and_grads`` through four SSD paths:

- ``plain256``: autograd through ``ssd_plain`` at the config's chunk of
  256 (the yardstick);
- ``plain64``: the same at chunk 64, another f32 algorithm of the same
  function;
- ``kernels``: ``SSDFunction`` on the card, the forward kernels
  (3xTF32 products) and the backward kernels;
- ``kernels_f32``: the same with the forward kernels built with
  ``REPRO_SSD_F32_PRODUCTS`` (a diagnostic build of ``csrc/ssd.cu``
  that only this tool loads): every product of the forward a plain f32
  sum on the CUDA cores;
- ``kfwd_pbwd`` / ``pfwd_kbwd``: the forward kernels with
  ``ssd_bwd_plain``, and the plain forward with the backward kernels.

For each of the last four against ``plain256``: the worst leaf's
max |difference| / max |plain256| and the loss's relative difference,
one ``DEPTH {json}`` line a depth.  Then the two plain chunkings at full
depth under two more weight seeds (``SEED`` lines), and the forward's
time in both builds at mamba2's heads, f32, in turns (``FWD_MS``).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import SyntheticSource  # noqa: E402
from repro_torch.kernels import ssd as kssd  # noqa: E402
from repro_torch.models import Model, ssd_block  # noqa: E402
from repro_torch.services.base import flatten_named  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402

ARCH = "mamba2-1.3b"
DEPTHS = (2, 4, 8, 16, 48)
RAW_FWD, RAW_BWD = kssd._ssd_cuda, kssd._ssd_bwd_cuda
F32_PRODUCTS = ("REPRO_SSD_F32_PRODUCTS",)


def forward_entry(defines=()):
    """The forward's C entry of a build of ``csrc/ssd.cu`` with
    ``defines``, bound as ``kssd._kernel`` binds the main one."""
    from repro_torch.kernels.build import load
    fn = load("ssd", defines).repro_ssd_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = kssd._kernel().argtypes
    return fn


def plain_forward(x, dt, A, B, C, D, h0, keep=False):
    """The forward kernels' raw launch replaced by its plain version."""
    out = kssd.ssd_keep_plain(x, dt, A, B, C, D, h0)
    return out if keep else out[:2]


def plain_backward(x, dt, A, B, C, D, h0, dy, dh, states, decay,
                   with_dh0=False):
    return kssd.ssd_bwd_plain(x, dt, A, B, C, D, h0, dy, dh,
                              with_dh0=with_dh0)


def gradients(model, params, batch, path):
    if path == "plain256":
        ssd_block.ssd = kssd.ssd_plain
    elif path == "plain64":
        ssd_block.ssd = (lambda *a, chunk=256: kssd.ssd_plain(*a, chunk=64))
    elif path == "kfwd_pbwd":
        kssd._ssd_bwd_cuda = plain_backward
    elif path == "pfwd_kbwd":
        kssd._ssd_cuda = plain_forward
    elif path == "kernels_f32":
        kssd._fn = forward_entry(F32_PRODUCTS)
    try:
        loss, _, grads = loss_and_grads(model, params, batch, remat="none")
    finally:
        ssd_block.ssd = kssd.ssd
        kssd._ssd_cuda, kssd._ssd_bwd_cuda = RAW_FWD, RAW_BWD
        kssd._fn = forward_entry()
    return float(loss), flatten_named(grads)


def worst(got, want):
    """(the worst leaf's max |diff| / max |want|, its name)."""
    errs = {k: float((got[k] - w).abs().max())
            / max(float(w.abs().max()), 1e-30) for k, w in want.items()}
    key = max(errs, key=errs.get)
    return errs[key], key


def setup(layers, seed):
    cfg = configs.get(ARCH).replace(compute_dtype="float32",
                                    n_layers=layers)
    model = Model(cfg)
    params = model.init(seed, device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             SyntheticSource(cfg.vocab, 128, 2, seed=seed).batch_at(0)
             .items()}
    return model, params, batch


def main() -> int:
    if not torch.cuda.is_available():
        print("train_parity_depth: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0))
    print("CARD", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    for layers in DEPTHS:
        model, params, batch = setup(layers, 2)
        base_loss, base = gradients(model, params, batch, "plain256")
        row = {"layers": layers}
        for path in ("plain64", "kernels", "kernels_f32", "kfwd_pbwd",
                     "pfwd_kbwd"):
            loss, grads = gradients(model, params, batch, path)
            err, leaf = worst(grads, base)
            row[path] = {"worst": err, "leaf": leaf,
                         "loss_rel": abs(loss / base_loss - 1)}
            del grads
        print("DEPTH", json.dumps(row), flush=True)
        del params, base
        torch.cuda.empty_cache()
    for seed in (3, 4):
        model, params, batch = setup(configs.get(ARCH).n_layers, seed)
        _, base = gradients(model, params, batch, "plain256")
        _, other = gradients(model, params, batch, "plain64")
        err, leaf = worst(other, base)
        print("SEED", json.dumps({"seed": seed, "plain64_worst": err,
                                  "leaf": leaf}), flush=True)
        del params, base, other
        torch.cuda.empty_cache()
    forward_times()
    return 0


def forward_times(rounds: int = 4, iters: int = 20):
    """The forward kernels' ms a call in both builds, f32, at mamba2's
    heads (H 64, P 64, G 1, N 128) on 2 x 2048 and 8 x 128, the builds in
    turns (main, f32, f32, main, ...)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    builds = {"3xtf32": forward_entry(), "f32": forward_entry(F32_PRODUCTS)}
    for B, S in ((2, 2048), (8, 128)):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x, Bm, Cm = rnd(B, S, 64, 64), rnd(B, S, 1, 128), rnd(B, S, 1, 128)
        dt = torch.rand((B, S, 64), generator=gen, device="cuda") * 0.1
        A = -torch.linspace(1.0, 16.0, 64, device="cuda")
        D = torch.ones(64, device="cuda")
        times = {k: [] for k in builds}
        order = [k for r in range(rounds) for k in
                 (("3xtf32", "f32") if r % 2 == 0 else ("f32", "3xtf32"))]
        for name in order:
            kssd._fn = builds[name]
            kssd._ssd_cuda(x, dt, A, Bm, Cm, D, None)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                kssd._ssd_cuda(x, dt, A, Bm, Cm, D, None)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / iters)
        kssd._fn = builds["3xtf32"]
        print("FWD_MS", json.dumps({"shape": [B, S, 64, 64, 128],
                                    "ms": times}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
