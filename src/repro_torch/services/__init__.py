from .admission import AdmissionController
from .base import (alloc_from_manifest, checksum_of, flatten_named,
                   manifest_of, replicated_call, unflatten_named,
                   verify_manifest)
from .checkpoint import CheckpointClient, CheckpointServer
from .datafeed import DataFeedClient, DataFeedServer
from .gateway import ServingGateway
from .membership import MembershipClient, MembershipServer

__all__ = [
    "AdmissionController", "CheckpointClient", "CheckpointServer",
    "DataFeedClient", "DataFeedServer", "MembershipClient",
    "MembershipServer", "ServingGateway",
    "replicated_call", "flatten_named", "unflatten_named", "manifest_of",
    "alloc_from_manifest", "verify_manifest", "checksum_of",
]
