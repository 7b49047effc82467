"""Service fabric (paper §"extreme-scale services"): registry-backed
service pools with load-balanced, locality-aware routing, per-call
deadlines/retries/hedging, credit-based flow control, and a unified
replicated control plane — a generic replicated-table core (leader
lease + delta gossip) hosting the registry's instance table and the
membership service's member table on every quorum node.

See DESIGN.md §7 for the registry schema, the balancer contract and the
credit/flow-control state machine, and §8 for the replication protocol;
docs/OPERATIONS.md is the operator's guide.
"""
from .affinity import SessionAffinity
from .balancer import (BALANCERS, Balancer, EwmaWeighted, LeastLoaded,
                       LocalityAware, RoundRobin, make_balancer,
                       prefer_instance)
from .flow import AdaptiveCreditGate, CreditGate
from .policy import (BudgetExhausted, DeadlineExceeded, FabricError,
                     NonRetryable, RetryPolicy, call_with_budget)
from .pool import PoolError, Replica, ServicePool
from .readcache import ReadCache, args_digest
from .registry import (RegistryClient, RegistryService, ServiceInstance,
                       resolve_service_uris)
from .replication import (PeerTracker, QuorumCaller, ReplicatedTable,
                          ReplicationCore, parse_registry_uris)
from .sharding import (ShardedRegistryClient, membership_home,
                       parse_shard_spec, registry_client_for, shard_of)

__all__ = [
    "Balancer", "BALANCERS", "RoundRobin", "LeastLoaded", "LocalityAware",
    "EwmaWeighted", "make_balancer", "prefer_instance", "SessionAffinity",
    "CreditGate", "AdaptiveCreditGate",
    "RetryPolicy", "call_with_budget",
    "FabricError", "DeadlineExceeded", "BudgetExhausted", "NonRetryable",
    "ServicePool", "PoolError", "Replica", "RegistryService",
    "RegistryClient", "ServiceInstance", "resolve_service_uris",
    "PeerTracker", "QuorumCaller", "ReplicatedTable", "ReplicationCore",
    "parse_registry_uris", "ReadCache", "args_digest",
    "shard_of", "parse_shard_spec", "membership_home",
    "ShardedRegistryClient", "registry_client_for",
]
