"""Plugin registry — ``na_initialize("tcp://...")`` equivalent.

URI-scheme dispatch plus multi-transport initialization: a semicolon-
joined URI (or a list of URIs) stands up one plugin per scheme wrapped in
:class:`MultiPlugin`, which resolves target address sets to the cheapest
reachable tier (self > sm > tcp — see DESIGN.md §2).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

from ..types import MercuryError, Ret
from .base import NAPlugin
from .multi import MultiPlugin, parse_addr_set
from .self_plugin import SelfPlugin
from .sm import SMPlugin
from .tcp import TCPPlugin

_PLUGINS = {
    "self": SelfPlugin,
    "sm": SMPlugin,
    "tcp": TCPPlugin,
}


def register_plugin(scheme: str, cls) -> None:
    _PLUGINS[scheme] = cls


def _initialize_one(uri: str, listen: bool) -> NAPlugin:
    scheme = uri.split("://", 1)[0] if "://" in uri else uri
    cls = _PLUGINS.get(scheme)
    if cls is None:
        raise MercuryError(Ret.INVALID_ARG, f"unknown NA plugin: {scheme}")
    if "://" not in uri:
        uri = None
    if cls is TCPPlugin:
        return cls(uri, listen=listen)
    return cls(uri)


def initialize(uri: Union[str, Sequence[str], None] = None,
               listen: bool = True) -> NAPlugin:
    """Create a plugin instance (or a tiered multi-transport stack).

    ``initialize("self://svc1")``, ``initialize("sm://svc1")``,
    ``initialize("tcp://127.0.0.1:0")``, ``initialize("tcp")`` (ephemeral
    port), ``initialize()`` (self, anon), and
    ``initialize("self://a;sm://a;tcp://127.0.0.1:0")`` or
    ``initialize(["sm://a", "tcp://127.0.0.1:0"])`` (multi-transport).
    """
    if uri is None:
        return SelfPlugin()
    uris: List[str] = list(uri) if not isinstance(uri, str) \
        else parse_addr_set(uri)
    if not uris:
        raise MercuryError(Ret.INVALID_ARG, f"empty NA uri: {uri!r}")
    if len(uris) == 1:
        return _initialize_one(uris[0], listen)
    return MultiPlugin([_initialize_one(u, listen) for u in uris])
