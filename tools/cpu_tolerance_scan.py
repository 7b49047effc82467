#!/usr/bin/env python3
"""How far the port's training numbers part from the JAX reference's on
the CPU, over many weight draws: the spread that the tolerances of
``tests/test_torch_train.py`` for granite-moe-3b-a800m, mamba2-1.3b and
recurrentgemma-9b are set against.

    JAX_PLATFORMS=cpu python3 tools/cpu_tolerance_scan.py --draws 32 --workers 4

The reference's ``Model.init`` folds each parameter's path into its key
with Python's ``hash``, so every process draws other weights: each draw
here is a process with its own ``PYTHONHASHSEED``.  A draw runs, for
each model, the test file's own helpers: the loss and every gradient
leaf against ``jax.value_and_grad`` of the reference's ``loss_fn`` (at
the test's ``JIMPL``), and the 5-step AdamW trajectory (weight decay
0.1).  One ``DRAW {json}`` line a draw and model: the worst leaf's error
over its largest entry, the loss's and the metrics' relative errors, and
the trajectory's worst relative gradient-norm and loss differences.

Then ``ORACLE`` lines: one SSD layer at reduced mamba2's heads (B 4, S
32, H 8, P 16, N 16, chunk 32, A from -1 to -16), the gradients of x,
dt, A, B, C, D by the reference's chunked XLA form (``ops.ssd``,
``impl="xla"``) and by the port's ``ssd_bwd_plain``, each against
``jax.vjp`` of ``ref.ssd_ref`` in f64: each one's error over the f64
gradient's largest entry.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite-moe-3b-a800m", "mamba2-1.3b", "recurrentgemma-9b")


def draw(arch: str) -> dict:
    """One draw of ``arch`` in this process (its PYTHONHASHSEED)."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import jax
    import jax.numpy as jnp
    import test_torch_train as T
    from repro_torch.train.optim import leaves
    from repro_torch.train.step import loss_and_grads

    jm, jp, tm, tp = T._pair(arch)
    batch = T._batch(0, tm.cfg.vocab)
    batch["targets"][0, :5] = -1

    def jloss(params):
        return jm.loss_fn(params, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, impl=T.JIMPL[arch],
                          remat="none")
    (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    loss, met, grads = loss_and_grads(tm, tp, T._tbatch(batch),
                                      remat="none")
    leaf = max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(leaves(grads), leaves(T._port(jg))))
    metrics = max(abs(float(met[k]) / float(jmet[k]) - 1)
                  for k in ("ce", "z_loss", "moe_lb", "moe_z")
                  if float(jmet[k]))
    ocfg = dict(lr=3e-3, warmup=2, decay_steps=10, weight_decay=0.1)
    gn = tl = 0.0
    for _, tmet, _, jtmet in T._run_both(T._pair(arch), ocfg, 5):
        gn = max(gn, abs(float(tmet["grad_norm"])
                         / float(jtmet["grad_norm"]) - 1))
        tl = max(tl, abs(float(tmet["loss"]) / float(jtmet["loss"]) - 1))
    return {"arch": arch, "hashseed": os.environ.get("PYTHONHASHSEED"),
            "leaf": leaf, "loss_rel": abs(float(loss) / float(jl) - 1),
            "metrics_rel": metrics, "trajectory_grad_norm_rel": gn,
            "trajectory_loss_rel": tl}


def oracle(seed: int) -> dict:
    """One SSD layer's gradients by the reference's chunked form and by
    the port's plain backward, each against the f64 sequential oracle."""
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import numpy as np
    import torch
    from repro.kernels import ops
    from repro.kernels.ref import ssd_ref
    from repro_torch.kernels import ssd as kssd
    jnp = jax.numpy
    rng = np.random.default_rng(seed)
    Bb, S, H, P, G, N = 4, 32, 8, 16, 1, 16
    f32 = np.float32
    x = rng.standard_normal((Bb, S, H, P)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, S, H)))).astype(f32)
    A = (-np.linspace(1, 16, H)).astype(f32)
    Bm = (rng.standard_normal((Bb, S, G, N)) * 0.3).astype(f32)
    Cm = (rng.standard_normal((Bb, S, G, N)) * 0.3).astype(f32)
    D = np.ones(H, f32)
    dy = rng.standard_normal((Bb, S, H, P)).astype(f32)

    def vjp(fn, dtype):
        def f(*a):
            return fn(*a)[0]
        _, back = jax.vjp(f, *[jnp.asarray(a, dtype)
                               for a in (x, dt, A, Bm, Cm, D)])
        return [np.asarray(g, np.float64) for g in back(jnp.asarray(dy,
                                                                   dtype))]
    jax.config.update("jax_enable_x64", True)
    truth = vjp(ssd_ref, jnp.float64)
    jax.config.update("jax_enable_x64", False)
    ref = vjp(lambda *a: ops.ssd(*a, chunk=32, impl="xla"), jnp.float32)
    t = torch.from_numpy
    port = [g.double().numpy() for g in kssd.ssd_bwd_plain(
        t(x), t(dt), t(A), t(Bm), t(Cm), t(D), None, t(dy), None,
        chunk=32)]
    out = {"seed": seed}
    for name, tr, r, p in zip(("dx", "ddt", "dA", "dB", "dC", "dD"),
                              truth, ref, port):
        scale = float(np.abs(tr).max())
        out[name] = {"reference": float(np.abs(r - tr).max()) / scale,
                     "port": float(np.abs(p - tr).max()) / scale}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=32)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--draw", metavar="ARCH", help=argparse.SUPPRESS)
    ap.add_argument("--oracle", type=int, metavar="SEED",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.draw:
        print(json.dumps(draw(args.draw)))
        return 0
    if args.oracle is not None:
        print(json.dumps(oracle(args.oracle)))
        return 0

    def run(cmd, hashseed="0"):
        env = dict(os.environ, PYTHONHASHSEED=hashseed,
                   JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
        out = subprocess.run([sys.executable, __file__, *cmd], env=env,
                             capture_output=True, text=True, check=True)
        return json.loads(out.stdout.strip().splitlines()[-1])

    jobs = [(["--draw", arch], str(seed)) for seed in range(1, args.draws + 1)
            for arch in ARCHS]
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        for row in pool.map(lambda job: run(*job), jobs):
            print("DRAW", json.dumps(row), flush=True)
        for row in pool.map(lambda s: run(["--oracle", str(s)]), (1, 2, 3)):
            print("ORACLE", json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
