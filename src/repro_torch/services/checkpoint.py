"""Checkpoint service — Mercury's bulk-data design applied to model state,
ported from ``src/repro/services/checkpoint.py``.

Save path (client → server):
  1. the client checksums every shard where it lies (the Fletcher-64
     kernel for tensors on the card) and copies the shards to host
     buffers,
  2. registers them as ONE multi-segment bulk handle,
  3. sends a small ``ckpt.put`` RPC carrying only the *descriptor*
     + manifest (shapes/dtypes/Fletcher-64 checksums),
  4. the server pulls the payload one-sidedly (pipelined chunks) into
     host buffers, verifies the checksums on its device (the card, or
     the CPU with ``device="cpu"``) in groups of shards of up to
     ``VERIFY_GROUP_BYTES``, stores, responds.
The RPC itself stays tiny no matter how many GB the checkpoint is —
exactly the paper's bulk/eager split (C3).

Restore reverses the flow: ``ckpt.get`` returns the manifest + a
server-side descriptor; the client pulls into host buffers, copies them
to its device and verifies them there.

``async_save`` = checksums and device→host copies now, bulk push on a
background thread (training continues during the transfer).

The wire format is the reference's: a checkpoint saved by either
package's client restores through the other's.  With ``registry=`` the
server registers itself as an instance of ``service`` in the fabric
registry, and a client given ``registry=`` instead of ``server_uri``
resolves it by name, as in the reference.
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Dict, Optional, Tuple

from ..core.bulk import BulkDescriptor
from ..core.executor import Engine
from ..core.types import MercuryError, Ret
from ..fabric.readcache import ReadCache
from ..models.common import resolve_device
from .base import (alloc_from_manifest, flatten_named, host_copy,
                   host_to_tensor, manifest_of,
                   unflatten_named, verify_manifest)


# the most bytes of shards the server copies to its device at once to
# verify them (a larger shard goes alone): one checksum batch a group
VERIFY_GROUP_BYTES = 256 << 20


def _verify_on(device, man: dict, host: dict) -> None:
    """Verify host buffers against the manifest on ``device``, a group of
    shards at a time (only one group's device copies are alive at once);
    raises for the first bad shard."""
    group, size = [], 0

    def verify(shards):
        verify_manifest(
            {"keys": [key for key, _, _ in shards],
             "checksums": [want for _, _, want in shards]},
            {key: host_to_tensor(host[key], name, device)
             for key, name, _ in shards})

    for shard in zip(man["keys"], man["dtypes"], man["checksums"]):
        nbytes = host[shard[0]].nbytes
        if group and size + nbytes > VERIFY_GROUP_BYTES:
            verify(group)
            group, size = [], 0
        group.append(shard)
        size += nbytes
    if group:
        verify(group)


class CheckpointServer:
    """Hosts checkpoints in host memory; every stored shard set stays
    registered for one-sided restore pulls.  Pulled shards are verified
    on ``device`` (default the card).  With ``registry=`` the server
    registers itself as an instance of service ``service`` so clients
    can resolve it by name through the fabric."""

    def __init__(self, engine: Engine, registry: Optional[str] = None,
                 service: str = "ckpt", *, device="cuda"):
        self.device = resolve_device(device)
        self.engine = engine
        self.store: Dict[Tuple[str, int], dict] = {}  #: guarded-by _lock
        self._lock = threading.Lock()
        engine.register("ckpt.put", self._put)
        engine.register("ckpt.get", self._get)
        engine.register("ckpt.list", self._list)
        engine.register("ckpt.delete", self._delete)
        self.instance = None
        if registry is not None:
            from ..fabric.registry import ServiceInstance
            self.instance = ServiceInstance(
                engine, registry, service,
                load_fn=lambda: float(self._count()))

    def _count(self) -> int:
        with self._lock:
            return len(self.store)

    def close(self) -> None:
        if self.instance is not None:
            self.instance.close()

    # -- handlers (run on the engine's handler pool) -------------------------
    def _put(self, req):
        name, step = req["name"], int(req["step"])
        man = req["manifest"]
        desc = BulkDescriptor.from_bytes(req["desc"])
        named = alloc_from_manifest(man)
        local = self.engine.expose(list(named.values()), read=False,
                                   write=True)
        try:
            self.engine.pull(req["origin"], desc, local)
        finally:
            local.free()
        _verify_on(self.device, man, named)
        handle = self.engine.expose(list(named.values()), read=True,
                                    write=False)
        with self._lock:
            old = self.store.pop((name, step), None)
            if old:
                old["handle"].free()
            self.store[(name, step)] = {
                "named": named, "manifest": man, "handle": handle,
                "time": time.time(),  # fablint: ok[wallclock] shown by ckpt.list, never used in arithmetic
            }
        return {"ok": True, "stored": len(named)}

    def _get(self, req):
        name = req["name"]
        step = req.get("step")
        with self._lock:
            if step is None:
                steps = [s for (n, s) in self.store if n == name]
                if not steps:
                    raise MercuryError(Ret.NOENTRY, f"no checkpoint {name}")
                step = max(steps)
            entry = self.store.get((name, int(step)))
        if entry is None:
            raise MercuryError(Ret.NOENTRY, f"no checkpoint {name}@{step}")
        return {
            "step": int(step),
            "manifest": entry["manifest"],
            "desc": entry["handle"].descriptor().to_bytes(),
            "origin": self.engine.uri,
        }

    def _list(self, _req):
        with self._lock:
            return {"checkpoints": [
                {"name": n, "step": s, "time": e["time"]}
                for (n, s), e in sorted(self.store.items())]}

    def _delete(self, req):
        with self._lock:
            e = self.store.pop((req["name"], int(req["step"])), None)
            if e:
                e["handle"].free()
        return {"ok": e is not None}


class CheckpointClient:
    def __init__(self, engine: Engine, server_uri: Optional[str] = None,
                 registry: Optional[str] = None, service: str = "ckpt",
                 cache_ttl: float = 0.0):
        """Address either directly (``server_uri``) or by service name
        through the fabric registry (``registry=`` + ``service=``).

        ``cache_ttl > 0`` caches ``ckpt.list`` reads (DESIGN.md §9):
        the server has no epoch stream, so validity is TTL-bounded plus
        self-invalidation — this client's own ``save``/``delete`` drop
        the cache immediately (read-your-writes), while other writers'
        checkpoints appear within the TTL."""
        if server_uri is None:
            if registry is None:
                raise ValueError("need server_uri or registry")
            from ..fabric.registry import resolve_service_uris
            server_uri = resolve_service_uris(engine, registry, service)[0]
        self.engine = engine
        self.server = server_uri
        self.cache = ReadCache(ttl=cache_ttl)
        self._pool = cf.ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="ckpt-async")

    @staticmethod
    def _snapshot(tree) -> Tuple[dict, dict]:
        """(manifest, host buffers): checksums where each shard lies,
        then host copies."""
        named = flatten_named(tree)
        man = manifest_of(named)
        return man, {k: host_copy(v) for k, v in named.items()}

    def _push(self, name: str, step: int, man: dict, host: dict) -> dict:
        handle = self.engine.expose(list(host.values()), read=True,
                                    write=False)
        try:
            out = self.engine.call(self.server, "ckpt.put", {
                "name": name, "step": step, "manifest": man,
                "desc": handle.descriptor().to_bytes(),
                "origin": self.engine.uri,
            }, timeout=120.0)
            self.cache.invalidate()       # read-your-writes for list()
            return out
        finally:
            handle.free()

    def save(self, name: str, step: int, tree) -> dict:
        man, host = self._snapshot(tree)
        return self._push(name, step, man, host)

    def async_save(self, name: str, step: int, tree) -> cf.Future:
        """Checksums and host copies now, transfer in the background."""
        man, host = self._snapshot(tree)
        return self._pool.submit(self._push, name, step, man, host)

    def restore(self, name: str, template, step: Optional[int] = None, *,
                device="cuda"):
        """Returns (tree shaped like ``template`` of tensors on
        ``device`` in the template's dtypes, step).  The shards are
        verified on ``device`` before the cast."""
        dev = resolve_device(device)
        meta = self.engine.call(self.server, "ckpt.get",
                                {"name": name, "step": step}, timeout=60.0)
        man = meta["manifest"]
        host = alloc_from_manifest(man)
        local = self.engine.expose(list(host.values()), read=False,
                                   write=True)
        try:
            self.engine.pull(meta["origin"],
                             BulkDescriptor.from_bytes(meta["desc"]), local)
        finally:
            local.free()
        named = {k: host_to_tensor(host.pop(k), d, dev)
                 for k, d in zip(man["keys"], man["dtypes"])}
        verify_manifest(man, named)
        return unflatten_named(template, named), meta["step"]

    def delete(self, name: str, step: int) -> bool:
        ok = self.engine.call(self.server, "ckpt.delete",
                              {"name": name, "step": step})["ok"]
        self.cache.invalidate()           # read-your-writes for list()
        return ok

    def list(self, fresh: bool = False) -> list:
        return self.cache.get_or_call(
            "ckpt.list", {},
            lambda: self.engine.call(self.server, "ckpt.list", {}),
            fresh=fresh)["checkpoints"]
