"""Distribution: the sharding resolver, collectives on a mesh, the
tensor-parallel layout of the sharded step and the pipeline stage
runner."""
from .sharding import (DEFAULT_RULES, bytes_per_device, gather_block,
                       local_block, merge_rules, reduce_scatter_block,
                       spec_for, tree_shardings, tree_specs)

__all__ = ["DEFAULT_RULES", "spec_for", "tree_specs", "tree_shardings",
           "bytes_per_device", "merge_rules", "local_block", "gather_block",
           "reduce_scatter_block"]
