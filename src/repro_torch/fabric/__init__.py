"""The fabric layer of the port: so far only the client-side read cache
(a verbatim copy of ``src/repro/fabric/readcache.py``), which the
checkpoint client uses.  Registry, pools and affinity routing are still
to be copied (ROADMAP A4)."""
from .readcache import ReadCache, args_digest

__all__ = ["ReadCache", "args_digest"]
