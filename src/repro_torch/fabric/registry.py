"""Service registry — the fabric's replicated name-resolution control
plane.

Instances of a named service register ``(service, address_set, capacity,
load)``; clients resolve a service name to the live instance set.  A
single monotonically increasing **epoch** covers the whole registry and
bumps whenever *membership* of any service changes (register, deregister,
expiry) — load reports deliberately do **not** bump it, so cached client
views stay valid while load churns and are refreshed cheaply via the
``fab.epoch`` poll.

**Replication** (DESIGN.md §8): the registry is one consumer of the
generic replicated control plane in :mod:`repro_torch.fabric.replication` —
its instance table is a :class:`~repro_torch.fabric.replication.ReplicatedTable`
hosted by a per-node :class:`~repro_torch.fabric.replication.ReplicationCore`.
Pass ``peers=`` (the same ordered URI list on every node) and N
``RegistryService`` instances form a quorum: a deterministic **leader
lease** makes exactly one replica authoritative for writes and epoch
bumps; the leader **delta-gossips** per-entry changes — keyed by its
``(nonce, epoch)`` stream and per-entry version stamps — to the
followers over the fabric's own RPC layer (``fab.gossip``), falling
back to full snapshots for peers behind the tombstone horizon;
followers serve ``fab.resolve``/``fab.epoch`` reads from the mirrored
view and *proxy* writes to the leaseholder.  With
``serve_membership=True`` the node also hosts the membership service
(``mem.*``) as a second table on the *same* core — one lease, one
gossip stream, so member liveness and expiry reaps survive leaseholder
death exactly like instance registrations do.  Leadership failover
presents to clients as a nonce change, which
:class:`~repro_torch.fabric.pool.ServicePool` already resyncs on.

Wire schema (all values plain pytree-of-scalars — see DESIGN.md §7/§8):

  fab.register    {service, uris, capacity?, load?, iid?, member_id?}
                  -> {iid, epoch}
  fab.deregister  {service, iid} -> {ok, epoch}
  fab.report      {service, iid, load} -> {epoch}          (heartbeat too)
  fab.resolve     {service} -> {epoch, nonce, instances: [{iid, uris,
                                                capacity, load, age}]}
  fab.services    {} -> {epoch, nonce, services: [name]}
  fab.epoch       {} -> {epoch, nonce, leader}
  fab.status      {} -> {role, leader, nonce, epoch, tables, gossip,
                         peers: [...], ...}
  fab.gossip      {from, leader, nonce, epochs, delta?, snapshot?}
                  -> {nonce, epochs, delta?, snapshot?}     (peers only)

The **nonce** identifies one authoritative epoch stream: epochs are only
comparable within one nonce.  A restarted registry resets its epoch to 0
and a failed-over leader starts a fresh stream, either of which a bare
``view.epoch < cached.epoch`` check would misread as a stale race
forever; clients (ServicePool) detect the nonce change and resync
instead.  Re-registering an existing ``iid`` with unchanged uris (the
``ServiceInstance._report_loop`` recovery path) does **not** bump the
epoch — membership did not change, and bumping would force full
``fab.resolve`` storms across every pool each time an instance recovers
from an expiry.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.executor import Engine
from ..core.na.multi import parse_addr_set
from ..core.types import MercuryError, Ret
from .readcache import ReadCache
from .replication import (QuorumCaller, ReplicationCore,
                          parse_registry_uris)

# instance-table key separator: keys must be flat strings for the
# replicated-table wire format; \x1f (ASCII unit separator) cannot
# appear in a service name or a hex iid
_KEY_SEP = "\x1f"


def _key(service: str, iid: str) -> str:
    return f"{service}{_KEY_SEP}{iid}"


class RegistryService:
    """Hosts the ``fab.*`` RPCs on an engine.  Single-node by default;
    pass ``peers=`` (the same ordered list on every node — order is
    leadership priority) to run as one replica of a quorum.
    ``serve_membership=True`` co-hosts the membership service
    (``mem.*``) on the same replication core, with its member expiries
    reaping bound instances on whichever node holds the lease."""

    def __init__(self, engine: Engine, membership=None,
                 instance_ttl: float = 3.0, sweep_interval: float = 0.5,
                 peers: Optional[Sequence[str]] = None,
                 self_uri: Optional[str] = None,
                 lease_ttl: float = 1.0, gossip_interval: float = 0.25,
                 delta_gossip: bool = True,
                 serve_membership: bool = False,
                 heartbeat_timeout: float = 2.0):
        self.engine = engine
        self.ttl = instance_ttl
        # the core's sweep/gossip threads start only after every table
        # and handler is attached: a node must never elect, sweep, or
        # answer some of its RPCs while others are still being wired
        self.core = ReplicationCore(
            engine, peers=peers, self_uri=self_uri, lease_ttl=lease_ttl,
            gossip_interval=gossip_interval, sweep_interval=sweep_interval,
            delta_gossip=delta_gossip, autostart=False)
        self.table = self.core.table("instances", ttl=instance_ttl)
        # member ids whose expiry still awaits reaping (follower-hosted
        # MembershipServer; see _members_expired) -> forget-after stamp
        self._pending_reaps: Dict[str, float] = {}  #: guarded-by core._lock
        self.core.add_tick_hook(self._apply_pending_reaps)
        self.membership = None
        if serve_membership:
            # lazy import: fabric must not hard-depend on services at
            # module load (services already lazily imports fabric).
            # Done BEFORE any fab.* handler registers: importing the
            # services package is seconds-heavy (jax), and a node that
            # answers fab.register while mem.join is still seconds away
            # hands cold-boot clients hard NOENTRYs
            from ..services.membership import MembershipServer
            self.membership = MembershipServer(
                engine, heartbeat_timeout=heartbeat_timeout,
                sweep_interval=sweep_interval, core=self.core)
            self.membership.on_expire(self._members_expired)
        engine.register("fab.register", self._register)
        engine.register("fab.deregister", self._deregister)
        # fab.report proxies to the leader in quorum mode — a nested
        # blocking call, so it must not run inline on the progress thread
        engine.register("fab.report", self._report, inline=peers is None)
        engine.register("fab.resolve", self._resolve, inline=True)
        engine.register("fab.services", self._services, inline=True)
        engine.register("fab.epoch", self._epoch, inline=True)
        engine.register("fab.status", self._status)
        if membership is not None:
            # duck-typed MembershipServer: reap instances whose member died
            membership.on_expire(self._members_expired)
        self.core.start()

    # -- leadership / compat -------------------------------------------------
    @property
    def is_leader(self) -> bool:
        return self.core.is_leader

    @property
    def self_uri(self) -> str:
        return self.core.self_uri

    @property
    def tracker(self):
        return self.core.tracker

    @property
    def epoch(self) -> int:
        with self.core._lock:             # the table shares the core lock
            return self.table.epoch

    @property
    def nonce(self) -> str:
        with self.core._lock:
            return self.core.nonce

    # -- handlers ------------------------------------------------------------
    def _register(self, req):
        lead = self.core.leader_for_writes()
        if lead is not None:
            return self.core.proxy(lead, "fab.register", req)
        service = req["service"]
        uris = req["uris"]
        if isinstance(uris, str):
            uris = parse_addr_set(uris)
        iid = req.get("iid") or uuid.uuid4().hex[:12]
        key = _key(service, iid)
        uris = list(uris)
        with self.core._lock:
            prev = self.table.get(key)
            # membership changed if the instance is new, moved to
            # different addresses, or rebound to a different member — a
            # member_id rebind must ride the versioned (retransmitted)
            # stream, or a lost soft push would leave some mirror
            # reaping against a stale binding forever.  A same-everything
            # re-register (the report loop's recovery path) must NOT
            # bump the epoch, or every recovery forces a fab.resolve
            # storm across all pools
            if (prev is None or prev["uris"] != uris
                    or prev["member_id"] != req.get("member_id")):
                self.table.put(key, {
                    "service": service, "iid": iid, "uris": uris,
                    "capacity": int(req.get("capacity", 0)),
                    "load": float(req.get("load", 0.0)),
                    "member_id": req.get("member_id"),
                })
            else:
                self.table.update(key,
                                  capacity=int(req.get("capacity",
                                                       prev["capacity"])),
                                  load=float(req.get("load",
                                                     prev["load"])))
            return {"iid": iid, "epoch": self.table.epoch}

    def _deregister(self, req):
        lead = self.core.leader_for_writes()
        if lead is not None:
            return self.core.proxy(lead, "fab.deregister", req)
        with self.core._lock:
            ok = self.table.delete(_key(req["service"], req["iid"]))
            return {"ok": ok, "epoch": self.table.epoch}

    def _report(self, req):
        lead = self.core.leader_for_writes()
        if lead is not None:
            return self.core.proxy(lead, "fab.report", req)
        key = _key(req["service"], req["iid"])
        with self.core._lock:
            inst = self.table.get(key)
            if inst is None:
                # expired instance re-announcing: treat as a (re)register
                raise MercuryError(Ret.NOENTRY,
                                   f"unknown instance {req['iid']}; "
                                   f"re-register")
            fields = {"load": float(req.get("load", inst["load"]))}
            if "capacity" in req:
                fields["capacity"] = int(req["capacity"])
            self.table.update(key, **fields)
            return {"epoch": self.table.epoch}

    def _resolve(self, req):
        service = req["service"]
        now = time.monotonic()
        with self.core._lock:
            out = [{"iid": v["iid"], "uris": list(v["uris"]),
                    "capacity": v["capacity"], "load": v["load"],
                    "age": now - v["last"]}
                   for _, v in self.table.items()
                   if v["service"] == service]
            return {"epoch": self.table.epoch, "nonce": self.core.nonce,
                    "instances": out}

    def _services(self, _req):
        with self.core._lock:
            # carries the full (nonce, epoch) token so the client read
            # cache holds it authoritatively (evicted on epoch bump or
            # nonce change), not merely until the TTL lapses
            return {"epoch": self.table.epoch, "nonce": self.core.nonce,
                    "services": sorted({v["service"]
                                        for _, v in self.table.items()})}

    def _epoch(self, _req):
        with self.core._lock:
            out = {"epoch": self.table.epoch, "nonce": self.core.nonce}
        out["leader"] = (self.core.self_uri if self.core.tracker is None
                         else self.core.tracker.leader_uri())
        return out

    def _status(self, _req):
        """Operator observability (docs/OPERATIONS.md): role, believed
        leaseholder, per-peer liveness + last-acked replication state,
        per-table entry counts/epochs, and delta-vs-snapshot gossip
        counters."""
        st = self.core.status()
        with self.core._lock:
            st.update(epoch=self.table.epoch,
                      instances=len(self.table),
                      services=sorted({v["service"]
                                       for _, v in self.table.items()}))
        return st

    # -- liveness ------------------------------------------------------------
    def _members_expired(self, member_ids: List[str]) -> None:
        """Member-expiry hook (``MembershipServer.on_expire``).  The
        leaseholder reaps directly; a follower-hosted membership server
        queues the member ids as *pending reaps* that the gossip loop
        applies/forwards until the instances are gone — a one-shot
        forward would lose the reap forever if it raced gossip (mirror
        not yet carrying the instance) or hit a leadership hiccup."""
        now = time.monotonic()
        with self.core._lock:
            for m in member_ids:
                # bounded memory + no poisoning of a future legitimate
                # re-registration: forget the reap after 2x instance TTL
                self._pending_reaps[m] = now + 2 * self.ttl
        self.core.mark_dirty()            # reap/forward promptly
        if self.core.is_leader:
            self._apply_pending_reaps()

    def _apply_pending_reaps(self) -> None:
        """Reap instances of expired members: delete locally when
        leading, else forward as deregisters to the leaseholder.
        Called from the expiry hook and retried every gossip tick until
        no instance matches a pending member id."""
        with self.core._lock:
            if not self._pending_reaps:
                return
            now = time.monotonic()
            self._pending_reaps = {m: t for m, t
                                   in self._pending_reaps.items()
                                   if t > now}
            pending = set(self._pending_reaps)
            dead = [(k, v["service"], v["iid"])
                    for k, v in self.table.items()
                    if v["member_id"] in pending]
            if self.core.is_leader:
                for k, _, _ in dead:
                    self.table.delete(k)
                return
        if not dead:
            return
        try:
            lead = self.core.leader_for_writes()
        except MercuryError:
            return                        # unsettled: retried next tick
        for _, service, iid in dead:
            try:
                self.engine.call(lead, "fab.deregister",
                                 {"service": service, "iid": iid,
                                  "_proxied": True},
                                 timeout=self.core._proxy_timeout)
            except Exception:
                pass                      # retried next tick

    def close(self) -> None:
        """Stop and join the control-plane threads (idempotent)."""
        self.core.close()

    stop = close


class RegistryClient:
    """Origin-side wrapper over the ``fab.*`` RPCs with replica failover.

    ``registry_uri`` is a registry *address set*: one endpoint per
    replica (list, or one comma-separated string); the underlying
    :class:`~repro_torch.fabric.replication.QuorumCaller` sticks to the
    endpoint that last answered and rotates on transport-class
    failures.

    ``cache_ttl > 0`` turns on the client-side idempotent read cache
    (DESIGN.md §9): ``fab.resolve``/``fab.epoch``/``fab.services`` hits
    within the TTL are served locally as long as the registry's
    ``(nonce, epoch)`` token has not advanced — every response and every
    write observes the token, so an epoch bump or a leader failover
    (nonce change) evicts immediately and no read is ever served from a
    superseded epoch stream.  ``fresh=True`` on a read bypasses the
    cached value for callers that must see the authority."""

    def __init__(self, engine: Engine, registry_uri, timeout: float = 10.0,
                 cache_ttl: float = 0.0):
        self.engine = engine
        self._caller = QuorumCaller(engine, registry_uri, timeout=timeout)
        self.uris = self._caller.uris
        self.timeout = timeout
        self.cache = ReadCache(ttl=cache_ttl)

    @property
    def registry(self) -> str:
        """The currently preferred endpoint (observability/tests)."""
        return self._caller.current

    def _call(self, name: str, req: dict):
        return self._caller.call(name, req)

    @staticmethod
    def _token_of(out: dict):
        return out.get("nonce"), out["epoch"]

    def register(self, service: str, uris, capacity: int = 0,
                 load: float = 0.0, iid: Optional[str] = None,
                 member_id: Optional[str] = None) -> str:
        out = self._call("fab.register", {
            "service": service, "uris": uris, "capacity": capacity,
            "load": load, "iid": iid, "member_id": member_id,
        })
        # read-your-writes: an epoch bumped by our own write evicts any
        # cached view immediately (no waiting out the TTL)
        self.cache.observe_epoch(out["epoch"])
        return out["iid"]

    def deregister(self, service: str, iid: str) -> bool:
        out = self._call("fab.deregister", {"service": service, "iid": iid})
        self.cache.observe_epoch(out["epoch"])
        return out["ok"]

    def report(self, service: str, iid: str, load: float,
               capacity: Optional[int] = None) -> int:
        req = {"service": service, "iid": iid, "load": load}
        if capacity is not None:
            req["capacity"] = capacity
        epoch = self._call("fab.report", req)["epoch"]
        self.cache.observe_epoch(epoch)
        return epoch

    def resolve(self, service: str, fresh: bool = False) -> dict:
        return self.cache.get_or_call(
            "fab.resolve", {"service": service},
            lambda: self._call("fab.resolve", {"service": service}),
            fresh=fresh, token_of=self._token_of)

    def services(self, fresh: bool = False) -> List[str]:
        return self.cache.get_or_call(
            "fab.services", {},
            lambda: self._call("fab.services", {}),
            fresh=fresh, token_of=self._token_of)["services"]

    def epoch(self, fresh: bool = False) -> int:
        return self.epoch_info(fresh=fresh)[0]

    def epoch_info(self, fresh: bool = False) -> Tuple[int, Optional[str]]:
        """(epoch, nonce) — the cheap staleness poll.  Epochs from
        different nonces are not comparable (registry restarted, or the
        lease failed over to a new leader)."""
        out = self.cache.get_or_call(
            "fab.epoch", {},
            lambda: self._call("fab.epoch", {}),
            fresh=fresh, token_of=self._token_of)
        return out["epoch"], out.get("nonce")

    def status(self) -> dict:
        """``fab.status`` of the currently preferred replica."""
        return self._call("fab.status", {})


def resolve_service_uris(engine: Engine, registry_uri, service: str,
                         timeout: float = 10.0) -> List[str]:
    """Resolve ``service`` to its instances' address sets (one
    semicolon-joined string per instance, registry order).  The thin
    entry point for clients that want name resolution without a full
    :class:`~repro_torch.fabric.pool.ServicePool` (checkpoint/datafeed).
    ``registry_uri`` may name one registry endpoint, the whole replica
    set (see :class:`RegistryClient`), or a sharded control plane
    (``'|'``-separated shard quorums, DESIGN.md §12 — the lookup goes
    straight to the shard that owns ``service``)."""
    from .sharding import registry_client_for  # deferred: import cycle
    client = registry_client_for(engine, registry_uri, service=service,
                                 timeout=timeout)
    view = client.resolve(service)
    if not view["instances"]:
        raise MercuryError(Ret.NOENTRY,
                           f"no live instances of service {service!r}")
    return [";".join(inst["uris"]) for inst in view["instances"]]


class ServiceInstance:
    """Self-registration helper for servers: registers this engine's
    address set under ``service`` and keeps the registration alive with
    periodic ``fab.report`` heartbeats carrying a live load sample.

    ``registry_uri`` may be a single endpoint or the replica set (the
    underlying :class:`RegistryClient` fails over).  ``load_fn`` returns
    the instance's current load (any float; the convention used by the
    built-in services is *outstanding work items*, e.g. active slots +
    queued requests).  ``close(deregister=False)`` simulates a crash:
    the reporter stops but the registry only learns via TTL/membership
    expiry — exactly the path the pool's failover covers.
    """

    def __init__(self, engine: Engine, registry_uri, service: str,
                 capacity: int = 0,
                 load_fn: Optional[Callable[[], float]] = None,
                 report_interval: float = 0.5,
                 member_id: Optional[str] = None,
                 uris: Optional[List[str]] = None):
        from .sharding import registry_client_for  # deferred: import cycle
        # sharded specs bind the reporter to the owning shard; the
        # heartbeat/re-register loop below is oblivious to the map
        self.client = registry_client_for(engine, registry_uri,
                                          service=service)
        self.service = service
        self.load_fn = load_fn
        self.interval = report_interval
        self.uris = uris if uris is not None else engine.uri
        self.capacity = capacity
        self.member_id = member_id
        self._stop = threading.Event()
        # pre-generate the iid client-side: registration is then
        # idempotent, so a register retried after a lost response (or
        # re-proxied across a leader failover) can never mint a ghost
        # duplicate under a second iid
        self.iid = uuid.uuid4().hex[:12]
        self.client.register(
            service, self.uris, capacity=capacity, iid=self.iid,
            load=load_fn() if load_fn else 0.0, member_id=member_id)
        self._thread = threading.Thread(target=self._report_loop, daemon=True,
                                        name=f"fabric-report[{service}]")
        self._thread.start()

    def _report_loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.client.report(self.service, self.iid,
                                   self.load_fn() if self.load_fn else 0.0)
            except MercuryError:
                # registry expired us (e.g. long GC pause, or a leader
                # failover dropped state written during a partition):
                # re-register under the old iid
                try:
                    self.client.register(
                        self.service, self.uris, capacity=self.capacity,
                        load=self.load_fn() if self.load_fn else 0.0,
                        iid=self.iid, member_id=self.member_id)
                except Exception:
                    pass
            except Exception:
                pass            # registry briefly unreachable: keep trying

    def close(self, deregister: bool = True) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=2.0)
        if deregister:
            try:
                self.client.deregister(self.service, self.iid)
            except Exception:
                pass
