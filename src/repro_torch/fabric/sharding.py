"""Sharded control plane: partition the instance table across ``M``
independent registry quorums by service-name hash (DESIGN.md §12).

The replicated registry (§8) removes the single-*node* ceiling but
still funnels every write through one leaseholder.  Sharding removes
the single-*quorum* ceiling: the name space is split across ``M``
independent :class:`~repro_torch.fabric.replication.ReplicationCore` quorums,
each owning the full lifecycle (register / report / resolve / expiry)
of the services that hash to it.  Shards share nothing — no cross-shard
replication, no global epoch — so aggregate write throughput scales
with ``M`` and a failover on one shard never stalls the others.

The shard map is *static config*: a ``|``-separated list of address
sets, one per shard quorum::

    tcp://a:7700,tcp://b:7700|tcp://a:7701,tcp://b:7701

Placement is rendezvous (highest-random-weight) hashing over the shard
*indices*: every name scores each shard with a keyed blake2b digest and
lives on the highest scorer.  Growing the map from ``M`` to ``M+1``
shards only introduces a new candidate, so a name either stays put or
moves to the new shard — ~``1/(M+1)`` of names remap, never a full
reshuffle (tests/test_sharding.py proves stability, balance and
minimal movement as properties).

Token discipline: each shard is its own ``(nonce, epoch)`` authority.
:class:`ShardedRegistryClient` therefore keeps one
:class:`~repro_torch.fabric.registry.RegistryClient` — and hence one
:class:`~repro_torch.fabric.readcache.ReadCache` with its own token — per
shard, so a restart or failover on shard ``k`` evicts exactly shard
``k``'s cached reads and the other shards' caches stay authoritative
(never compare epochs across shards: they are independent counters
under independent nonces).
"""
from __future__ import annotations

import hashlib
import re
from typing import List, Optional, Sequence, Tuple, Union

from ..core.executor import Engine
from ..telemetry import metrics as _metrics
from .registry import RegistryClient

__all__ = [
    "SHARD_SEP", "shard_of", "parse_shard_spec", "format_shard_spec",
    "is_sharded", "membership_home", "shard_addr",
    "ShardedRegistryClient", "registry_client_for",
]

# Shard separator inside a registry address spec.  Each shard is a
# normal registry address set (comma-separated replica endpoints, each
# possibly ';'-joined multi-transport), so '|' is the only level left.
SHARD_SEP = "|"


def _score(service: str, shard: int) -> int:
    """Rendezvous weight of ``service`` on shard index ``shard``.

    Keyed blake2b — *not* Python's salted ``hash()`` — so the map is
    identical across processes, hosts and interpreter restarts.
    """
    h = hashlib.blake2b(f"{service}\x1fshard-{shard}".encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "big")


def shard_of(service: str, shards: Union[int, Sequence]) -> int:
    """Owning shard index of ``service`` under an ``M``-shard map.

    ``shards`` is the shard count or any sized shard config (e.g. the
    list from :func:`parse_shard_spec`).  Deterministic across
    processes, balanced to ~1/M per shard, and monotone under growth:
    adding shard ``M`` only ever moves names *to* shard ``M``.

    >>> shard_of("embedder", 4) == shard_of("embedder", 4)
    True
    >>> shard_of("embedder", 1)
    0
    >>> all(shard_of(f"svc-{i}", 4) in range(4) for i in range(32))
    True
    """
    n = shards if isinstance(shards, int) else len(shards)
    if n < 1:
        raise ValueError("shard map must have at least one shard")
    if n == 1:
        return 0
    best, best_score = 0, -1
    for i in range(n):
        s = _score(service, i)
        if s > best_score:          # strict: ties break to lowest index
            best, best_score = i, s
    return best


def is_sharded(registry_uri) -> bool:
    """True if ``registry_uri`` is a multi-shard spec (contains '|')."""
    return isinstance(registry_uri, str) and SHARD_SEP in registry_uri


def parse_shard_spec(spec) -> List[str]:
    """Split a shard spec into per-shard address-set strings.

    Accepts a ``|``-separated string, a list of address-set strings, or
    a single unsharded address set (one-element result).
    """
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.split(SHARD_SEP)]
    else:
        parts = [p if isinstance(p, str) else ",".join(p) for p in spec]
    parts = [p for p in parts if p]
    if not parts:
        raise ValueError(f"empty shard spec: {spec!r}")
    return parts


def format_shard_spec(shards: Sequence) -> str:
    """Inverse of :func:`parse_shard_spec`."""
    return SHARD_SEP.join(parse_shard_spec(shards))


def shard_addr(addr: str, k: int) -> str:
    """Shard ``k``'s address derived from a base address.

    The co-hosting convention shared by ``launch.registry --shards``,
    the scale benchmark and the operations guide: port-carrying
    endpoints get ``port + k``; name-based endpoints (``sm://`` /
    ``self://``) get a ``-k`` suffix.  Shard 0 is the base address
    itself.  Multi-transport (``;``-joined) sets offset each leg.

    >>> shard_addr("tcp://10.0.0.1:7700", 2)
    'tcp://10.0.0.1:7702'
    >>> shard_addr("sm://ctrl", 1)
    'sm://ctrl-1'
    >>> shard_addr("tcp://h:7700", 0)
    'tcp://h:7700'
    """
    if k == 0:
        return addr
    legs = []
    for leg in addr.split(";"):
        m = re.search(r":(\d+)$", leg)
        if m:
            legs.append(f"{leg[:m.start()]}:{int(m.group(1)) + k}")
        else:
            legs.append(f"{leg}-{k}")
    return ";".join(legs)


def membership_home(registry_uri) -> str:
    """The address set that hosts the membership table.

    Membership is *not* sharded — the member table describes hosts, not
    services, and stays far smaller than the instance table — so by
    convention it rides shard 0's quorum.  Unsharded specs (plain
    strings or endpoint lists) pass through unchanged, so callers can
    apply this unconditionally.
    """
    if not is_sharded(registry_uri):
        return registry_uri
    return parse_shard_spec(registry_uri)[0]


class ShardedRegistryClient:
    """Client for a sharded registry: fans ``fab.*`` calls to the
    owning shard and merges the cross-shard reads.

    Duck-type compatible with :class:`~repro_torch.fabric.registry.
    RegistryClient` for every per-service operation (``register`` /
    ``deregister`` / ``report`` / ``resolve``), which route to the one
    shard that owns the service name.  ``services()`` fans out to all
    shards and returns the sorted union; ``status()`` / ``epoch_info``
    report per shard, because there is no global epoch to pretend to.

    Caching: one :class:`RegistryClient` (one read cache, one
    ``(nonce, epoch)`` token) per shard — see the module docstring for
    the token rules.
    """

    def __init__(self, engine: Engine, registry_uri, timeout: float = 10.0,
                 cache_ttl: float = 0.0):
        self.engine = engine
        self.shard_uris = parse_shard_spec(registry_uri)
        self.clients: List[RegistryClient] = [
            RegistryClient(engine, uris, timeout=timeout,
                           cache_ttl=cache_ttl)
            for uris in self.shard_uris
        ]
        self.timeout = timeout
        # per-shard call counters: 'shard' is bounded by the static map
        # size, well inside the cardinality policy (DESIGN.md §10)
        self._m_calls = [_metrics.counter("fabric.shard.calls", shard=i)
                         for i in range(len(self.clients))]

    # -- shard map ---------------------------------------------------------

    @property
    def nshards(self) -> int:
        return len(self.clients)

    def shard_of(self, service: str) -> int:
        """Owning shard index for ``service`` under this map."""
        return shard_of(service, self.clients)

    def client_for(self, service: str) -> RegistryClient:
        """The owning shard's plain client (single-shard callers such
        as :class:`~repro_torch.fabric.pool.ServicePool` bind to this once
        and keep their whole refresh/token path unchanged)."""
        return self.clients[self.shard_of(service)]

    def _route(self, service: str) -> RegistryClient:
        shard = self.shard_of(service)
        self._m_calls[shard].inc()
        return self.clients[shard]

    # -- per-service ops: route to the owning shard ------------------------

    def register(self, service: str, uris, capacity: int = 0,
                 load: float = 0.0, iid: Optional[str] = None,
                 member_id: Optional[str] = None) -> str:
        return self._route(service).register(
            service, uris, capacity=capacity, load=load, iid=iid,
            member_id=member_id)

    def deregister(self, service: str, iid: str) -> bool:
        return self._route(service).deregister(service, iid)

    def report(self, service: str, iid: str, load: float,
               capacity: Optional[int] = None) -> int:
        return self._route(service).report(service, iid, load,
                                           capacity=capacity)

    def resolve(self, service: str, fresh: bool = False) -> dict:
        return self._route(service).resolve(service, fresh=fresh)

    # -- cross-shard reads -------------------------------------------------

    def services(self, fresh: bool = False) -> List[str]:
        """Sorted union of every shard's service list.

        Each shard's slice is fetched under that shard's own cache
        token, so the merge is a union of per-shard authoritative
        views — there is no cross-shard snapshot point (§12).
        """
        names = set()
        for i, client in enumerate(self.clients):
            self._m_calls[i].inc()
            names.update(client.services(fresh=fresh))
        return sorted(names)

    def epoch_info(self, fresh: bool = False
                   ) -> List[Tuple[int, Optional[str]]]:
        """Per-shard ``(epoch, nonce)`` list, shard order.  Tokens from
        different shards are never comparable with one another."""
        return [c.epoch_info(fresh=fresh) for c in self.clients]

    def status(self) -> dict:
        """``fab.status`` of every shard's preferred replica."""
        return {"shards": [c.status() for c in self.clients]}

    # -- cache plumbing ----------------------------------------------------

    def invalidate(self) -> None:
        """Drop every shard's cached reads (tokens survive)."""
        for c in self.clients:
            c.cache.invalidate()


def registry_client_for(engine: Engine, registry_uri,
                        service: Optional[str] = None,
                        timeout: float = 10.0, cache_ttl: float = 0.0):
    """Build the right registry client for an address spec.

    Unsharded specs get a plain :class:`RegistryClient`.  Sharded specs
    (``'|'`` present) get a :class:`ShardedRegistryClient` — unless
    ``service`` is given, in which case the caller only ever talks
    about one name and gets the *owning shard's* plain client directly:
    this is how :class:`~repro_torch.fabric.pool.ServicePool` and
    :class:`~repro_torch.fabric.registry.ServiceInstance` route through a
    sharded control plane with their epoch-poll and token logic
    untouched.
    """
    if not is_sharded(registry_uri):
        return RegistryClient(engine, registry_uri, timeout=timeout,
                              cache_ttl=cache_ttl)
    shards = parse_shard_spec(registry_uri)
    if service is not None:
        return RegistryClient(engine, shards[shard_of(service, shards)],
                              timeout=timeout, cache_ttl=cache_ttl)
    return ShardedRegistryClient(engine, shards, timeout=timeout,
                                 cache_ttl=cache_ttl)
