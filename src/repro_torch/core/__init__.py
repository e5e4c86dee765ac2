"""PI core on PyTorch/CUDA — the counterpart of ``repro.core``.

Public surface:
  PIConfig, PIIndex, build, empty, execute, lookup, traverse, rebuild,
  maybe_rebuild, repack, range_agg,
  search/insert/delete_batch                               (single shard)
  SearchEngine, get_engine, Probe, BACKENDS, with_backend  (descent backends)
  from_numpy_leaves, to_numpy_leaves, flat_leaves,
  from_flat_leaves, leaf_spec                              (state transfer)
  ShardedPIIndex, build_sharded, execute_sharded, make_sharded_executor,
  make_mesh, Mesh, gather_shards                     (S shards on P ranks)
  rebalance_from_load / rebalance_from_sample              (NUMA analogue)
  RefIndex                                                 (oracle)
"""
from repro_torch.core.batch import SEARCH, INSERT, DELETE, RANGE
from repro_torch.core.engine import BACKENDS, Probe, SearchEngine, get_engine
from repro_torch.core.index import (
    PIConfig, PIIndex, build, empty, execute, execute_impl,
    execute_launch_count, flat_leaves,
    from_flat_leaves, from_numpy_leaves, incremental_fits, leaf_spec,
    live_items, lookup, traverse, range_agg, rebuild, rebuild_tier,
    maybe_rebuild, needs_rebuild, repack,
    search_batch, insert_batch, delete_batch, to_numpy_leaves,
    validate_layout, with_backend,
)
from repro_torch.core.distributed import (
    Mesh, ShardedPIIndex, build_sharded, collect_pairs, dispatch_plan,
    execute_sharded, gather_shards, leaf_spec_sharded, make_mesh,
    make_sharded_executor,
    maybe_rebuild_sharded, maybe_rebuild_shards, rebuild_sharded,
    scatter_to_buffer, shard_of, stack_shards,
)
from repro_torch.core.rebalance import (
    load_imbalance, rebalance_from_load, rebalance_from_sample,
)
from repro_torch.core.ref import RefIndex

__all__ = [
    "SEARCH", "INSERT", "DELETE", "RANGE", "PIConfig", "PIIndex", "build",
    "empty", "execute", "execute_impl", "execute_launch_count",
    "flat_leaves", "from_flat_leaves",
    "from_numpy_leaves", "incremental_fits", "leaf_spec", "live_items",
    "lookup", "traverse", "range_agg",
    "rebuild",
    "rebuild_tier", "maybe_rebuild", "needs_rebuild", "repack",
    "search_batch", "insert_batch", "delete_batch", "to_numpy_leaves",
    "validate_layout", "with_backend",
    "SearchEngine", "get_engine", "Probe", "BACKENDS",
    "ShardedPIIndex", "build_sharded",
    "execute_sharded", "make_sharded_executor", "rebuild_sharded",
    "maybe_rebuild_sharded", "maybe_rebuild_shards", "collect_pairs",
    "dispatch_plan", "scatter_to_buffer", "Mesh", "make_mesh",
    "gather_shards",
    "leaf_spec_sharded", "shard_of", "stack_shards",
    "rebalance_from_load", "rebalance_from_sample", "load_imbalance",
    "RefIndex",
]
