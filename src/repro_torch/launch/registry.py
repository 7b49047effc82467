"""Registry node launcher — replicas of the fabric's control plane.

Every node of a quorum is started with the SAME ordered ``--peers`` list
(order is leadership priority; the lowest-ranked live replica holds the
leader lease) and its own entry as ``--listen``.  Clients — pools,
``ServiceInstance``s, ``--registry`` flags — are given the whole
comma-separated set and fail over between replicas on their own.

Each node hosts the **unified control plane**: the registry's instance
table and the membership service's member table ride the same leader
lease and delta-gossip stream (``mem.*`` is served by every node —
follower reads, writes proxied to the leaseholder), so member liveness
and expiry reaps survive leaseholder death.  ``--no-membership`` turns
the membership service off; ``--full-gossip`` falls back to full-state
snapshot gossip (the delta protocol is the default).

**Sharding** (DESIGN.md §12): ``--shards M`` splits the name space
across M independent quorums by rendezvous hash.  Shard ``k`` listens
on the base ``--listen`` address offset by ``k`` (port + k, or a
``-k`` name suffix — see ``repro_torch.fabric.sharding.shard_addr``) and the
same offset applies to every ``--peers`` entry; alternatively give
``--peers`` as an explicit ``|``-separated per-shard list.  By default
one process co-hosts all M shards; ``--shard-index K`` hosts only
shard K, for one-process-per-shard (or per-host) deployments.  The
membership plane is unsharded and rides shard 0.  Clients take the
``|``-joined spec the launcher prints.

  # three-node quorum (run one per host):
  python -m repro_torch.launch.registry --listen tcp://10.0.0.1:7700 \\
      --peers tcp://10.0.0.1:7700,tcp://10.0.0.2:7700,tcp://10.0.0.3:7700
  ...same command on 10.0.0.2 / 10.0.0.3 with their --listen...

  # single-node (development):
  python -m repro_torch.launch.registry --listen tcp://127.0.0.1:7700

  # four shards co-hosted (dev) on ports 7700..7703:
  python -m repro_torch.launch.registry --listen tcp://127.0.0.1:7700 --shards 4

  # shard 2 of 4 as its own process:
  python -m repro_torch.launch.registry --listen tcp://127.0.0.1:7700 \\
      --shards 4 --shard-index 2

See docs/OPERATIONS.md for deployment guidance and DESIGN.md §8/§12 for
the replication and sharding protocols.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.executor import Engine
from repro_torch.fabric import RegistryService
from repro_torch.fabric.sharding import SHARD_SEP, parse_shard_spec, shard_addr
from repro_torch.telemetry import trace


def _shard_peer_sets(peers_arg, shards: int):
    """Per-shard ordered peer lists (or ``None`` for single-node
    shards) from either a base list (offset convention) or an explicit
    ``|``-separated per-shard spec."""
    if not peers_arg:
        return [None] * shards
    if SHARD_SEP in peers_arg:
        segments = parse_shard_spec(peers_arg)
        if len(segments) != shards:
            raise SystemExit(
                f"--peers names {len(segments)} shards but --shards is "
                f"{shards}")
        return [[p.strip() for p in seg.split(",") if p.strip()]
                for seg in segments]
    base = [p.strip() for p in peers_arg.split(",") if p.strip()]
    return [[shard_addr(p, k) for p in base] for k in range(shards)]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="fabric registry node (control plane replica)")
    ap.add_argument("--listen", required=True,
                    help="this node's address (set), e.g. tcp://0.0.0.0:7700"
                         " — with --shards it is the shard-0 base address")
    ap.add_argument("--peers", default=None, metavar="URI,URI,...",
                    help="ordered quorum peer list (identical on every "
                         "node; order = leadership priority).  Omit for a "
                         "single-node registry.  With --shards: either a "
                         "base list (each entry offset per shard) or an "
                         "explicit '|'-separated per-shard list.")
    ap.add_argument("--self", dest="self_uri", default=None,
                    help="this node's entry in --peers when it differs "
                         "from the resolved --listen uri (e.g. listening "
                         "on 0.0.0.0 but advertised by host IP); offset "
                         "per shard like --listen")
    ap.add_argument("--shards", type=int, default=1, metavar="M",
                    help="shard the name space across M independent "
                         "quorums (DESIGN.md §12; default 1)")
    ap.add_argument("--shard-index", type=int, default=None, metavar="K",
                    help="host only shard K of the --shards map in this "
                         "process (default: co-host all M shards)")
    ap.add_argument("--instance-ttl", type=float, default=3.0,
                    help="seconds without a fab.report before an "
                         "instance is expired")
    ap.add_argument("--lease-ttl", type=float, default=1.0,
                    help="leader lease: seconds of gossip silence before "
                         "a peer is presumed dead")
    ap.add_argument("--gossip-interval", type=float, default=0.25,
                    help="seconds between gossip rounds")
    ap.add_argument("--membership", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the membership plane (mem.*) from this "
                         "node's replicated member table; member "
                         "expiries reap bound instances (default: on; "
                         "sharded maps serve it from shard 0 only)")
    ap.add_argument("--heartbeat-timeout", type=float, default=2.0,
                    help="seconds without a mem.heartbeat before a "
                         "member is expired")
    ap.add_argument("--full-gossip", action="store_true",
                    help="replicate with full-state snapshot gossip "
                         "instead of per-entry deltas (debug/fallback)")
    ap.add_argument("--trace-sample", type=float, default=None,
                    metavar="P",
                    help="head-sampling probability for distributed "
                         "traces rooted here (0..1; default honors "
                         "REPRO_TRACE_SAMPLE, falling back to 0.01). "
                         "Sampled spans are served via dbg.trace")
    args = ap.parse_args(argv)

    if args.trace_sample is not None:
        trace.configure(sample=args.trace_sample)
    if args.shards < 1:
        raise SystemExit("--shards must be >= 1")
    if args.shard_index is not None and not (
            0 <= args.shard_index < args.shards):
        raise SystemExit("--shard-index out of range for --shards")

    own = ([args.shard_index] if args.shard_index is not None
           else list(range(args.shards)))
    peer_sets = _shard_peer_sets(args.peers, args.shards)

    engines, svcs = [], []
    for k in own:
        engine = Engine(shard_addr(args.listen, k))
        peers = peer_sets[k]
        svc = RegistryService(
            engine, instance_ttl=args.instance_ttl, peers=peers,
            self_uri=(shard_addr(args.self_uri, k)
                      if args.self_uri else None),
            lease_ttl=args.lease_ttl,
            gossip_interval=args.gossip_interval,
            delta_gossip=not args.full_gossip,
            serve_membership=args.membership and k == 0,
            heartbeat_timeout=args.heartbeat_timeout)
        engines.append(engine)
        svcs.append(svc)
        print(f"registry shard {k}/{args.shards} at {engine.uri}"
              + (f" (quorum of {len(peers)}, priority "
                 f"{peers.index(svc.self_uri)})" if peers else " (single)")
              + (", membership plane on"
                 if args.membership and k == 0 else ""),
              flush=True)
    # the client-side spec for this map ('|'-joined shard address sets)
    spec = SHARD_SEP.join(
        ",".join(peer_sets[k]) if peer_sets[k] else shard_addr(args.listen, k)
        for k in range(args.shards))
    print(f"registry spec: {spec}", flush=True)

    try:
        last_roles = {k: None for k in own}
        while True:
            time.sleep(2.0)
            for k, svc in zip(own, svcs):
                st = svc._status({})
                if st["role"] != last_roles[k]:
                    g = st.get("gossip", {})
                    print(f"[registry shard {k}] role={st['role']} "
                          f"leader={st['leader']} epoch={st['epoch']} "
                          f"instances={st['instances']} "
                          f"tables={ {n: t['entries'] for n, t in st['tables'].items()} } "
                          f"gossip(delta/snap)="
                          f"{g.get('delta_pushes', 0)}/"
                          f"{g.get('snapshot_pushes', 0)}", flush=True)
                    last_roles[k] = st["role"]
    except KeyboardInterrupt:
        pass
    finally:
        for svc in svcs:
            svc.close()
        for engine in engines:
            engine.shutdown()


if __name__ == "__main__":
    main()
