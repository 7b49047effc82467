from .base import (EXPECTED_MSG_LIMIT, NAAddress, NACallback, NACap,
                   NAMemHandle, NAOp, NAPlugin, SCHEME_TIERS, TIER_NET,
                   TIER_SELF, TIER_SM, UNEXPECTED_MSG_LIMIT)
from .multi import MultiPlugin, parse_addr_set
from .registry import initialize, register_plugin
from .self_plugin import SelfPlugin
from .sm import SMPlugin
from .tcp import TCPPlugin

__all__ = [
    "NAAddress", "NACallback", "NACap", "NAMemHandle", "NAOp", "NAPlugin",
    "UNEXPECTED_MSG_LIMIT", "EXPECTED_MSG_LIMIT", "SCHEME_TIERS",
    "TIER_SELF", "TIER_SM", "TIER_NET", "initialize", "register_plugin",
    "parse_addr_set", "SelfPlugin", "SMPlugin", "TCPPlugin", "MultiPlugin",
]
