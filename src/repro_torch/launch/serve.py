"""Serving launcher: model server behind the Mercury gateway + demo client.

Starts a ServeEngine for the chosen arch (the full published config
unless ``--reduced``) with seeded random weights on ``--device`` (default
``cuda``), exposes it through the ServingGateway over the tcp NA plugin,
and — in --demo mode — runs a client engine that submits a few prompts
and prints the completions.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --demo
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --demo --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --listen tcp://0.0.0.0:7777
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --registry tcp://127.0.0.1:7700 --member-id gw-0   # routable by name
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.core.executor import Engine
from repro_torch.models import Model
from repro_torch.models.common import resolve_device
from repro_torch.serve.engine import ServeEngine
from repro_torch.services import ServingGateway
from repro_torch.telemetry import trace


def main(argv=None):
    """Run the server; with ``--demo`` return the demo's completions and
    the gateway's final ``gen.stats``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device for weights, cache and kernels; "
                         "'cpu' runs the kernels' plain versions")
    ap.add_argument("--listen", default="tcp://127.0.0.1:0")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--registry", default=None, metavar="URI[,URI...]",
                    help="fabric registry to self-register with (service "
                         "'gen'): replicas started this way are routable "
                         "through a ServicePool.  For a replicated "
                         "registry pass the whole comma-separated quorum "
                         "address set; registration and heartbeats fail "
                         "over between the replicas (DESIGN.md §8)")
    ap.add_argument("--service", default="gen",
                    help="service name to register under (with --registry)")
    ap.add_argument("--member-id", default=None,
                    help="join the control plane's membership service "
                         "(mem.*, served by the same registry quorum) "
                         "under this id and bind the registration to "
                         "it: if this node dies, member expiry reaps "
                         "the instance without waiting for the "
                         "instance TTL (requires the registry to run "
                         "with its membership plane on — the default)")
    ap.add_argument("--trace-sample", type=float, default=None,
                    metavar="P",
                    help="head-sampling probability for distributed "
                         "traces rooted here (0..1; default honors "
                         "REPRO_TRACE_SAMPLE, falling back to 0.01)")
    args = ap.parse_args(argv)

    if args.trace_sample is not None:
        trace.configure(sample=args.trace_sample)

    device = resolve_device(args.device)
    cfg = configs.reduced(args.arch) if args.reduced else configs.get(args.arch)
    model = Model(cfg)
    params = model.init(0, device=device)
    serve = ServeEngine(model, params, max_len=args.max_len,
                        n_slots=args.slots, device=device)

    server = Engine(args.listen)
    try:
        gw = ServingGateway(server, serve, registry=args.registry,
                            service=args.service, member_id=args.member_id)
    except BaseException:
        server.shutdown()
        raise
    print(f"serving {cfg.name} on {device} at {server.uri} "
          f"({args.slots} slots, max_len {args.max_len})"
          + (f", registered with {args.registry} as {args.service!r}"
             if args.registry else "")
          + (f", member {args.member_id!r}" if args.member_id else ""),
          flush=True)

    if not args.demo:
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            gw.stop()
            server.shutdown()
        return None

    rng = np.random.default_rng(0)
    try:
        with Engine("tcp://127.0.0.1:0") as client:
            t0 = time.monotonic()
            rids = []
            for i in range(6):
                prompt = rng.integers(1, cfg.vocab, size=5 + i).tolist()
                rids.append(client.call(server.uri, "gen.submit",
                                        {"tokens": prompt, "max_new": 12,
                                         "temperature": 0.7}))
            outs = []
            for r in rids:
                out = client.call(server.uri, "gen.result",
                                  {"rid": r["rid"], "wait": True},
                                  timeout=120.0)
                print(f"rid {r['rid']}: {out['tokens']}")
                outs.append(out)
            stats = client.call(server.uri, "gen.stats", {})
            print("stats:", stats, f"({time.monotonic() - t0:.1f}s)")
    finally:
        gw.stop()
        server.shutdown()
    return outs, stats


if __name__ == "__main__":
    main()
