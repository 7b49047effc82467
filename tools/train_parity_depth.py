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
- ``kfwd_pbwd`` / ``pfwd_kbwd``: the forward kernels with
  ``ssd_bwd_plain``, and the plain forward with the backward kernels.

For each of the last four against ``plain256``: the worst leaf's
max |difference| / max |plain256| and the loss's relative difference,
one ``DEPTH {json}`` line a depth.  Then the two plain chunkings at full
depth under two more weight seeds (``SEED`` lines).
"""
from __future__ import annotations

import json
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
    try:
        loss, _, grads = loss_and_grads(model, params, batch, remat="none")
    finally:
        ssd_block.ssd = kssd.ssd
        kssd._ssd_cuda, kssd._ssd_bwd_cuda = RAW_FWD, RAW_BWD
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
    for layers in DEPTHS:
        model, params, batch = setup(layers, 2)
        base_loss, base = gradients(model, params, batch, "plain256")
        row = {"layers": layers}
        for path in ("plain64", "kernels", "kfwd_pbwd", "pfwd_kbwd"):
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
