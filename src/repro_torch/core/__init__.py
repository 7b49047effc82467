"""Mercury-style RPC core (the paper's contribution), in Python/JAX-land.

Layering (bottom-up), mirroring the paper's Figure 1:

    na/         network abstraction layer (plugins: self, tcp)
    proc.py     argument serialization (hg_proc)
    rpc.py      RPC operation layer (register/forward/respond)
    bulk.py     large-data transfers (descriptors + one-sided pipelined RMA)
    progress.py completion queue + progress/trigger
    executor.py request-model & multithreaded shims (built ON TOP, per paper)
"""
from .bulk import (BulkDescriptor, BulkHandle, BulkOp, BulkOpType,
                   bulk_transfer, expose_arrays)
from .executor import Engine, RemoteError
from .progress import Context
from .rpc import Handle, HGClass
from .types import CallbackInfo, Flags, MercuryError, OpType, Ret

__all__ = [
    "BulkDescriptor", "BulkHandle", "BulkOp", "BulkOpType", "bulk_transfer",
    "expose_arrays", "Engine", "RemoteError", "Context", "Handle", "HGClass",
    "CallbackInfo", "Flags", "MercuryError", "OpType", "Ret",
]
