"""PI core on PyTorch/CUDA — the single-shard part of ``repro.core``.

Public surface:
  PIConfig, PIIndex, build, empty, execute, lookup, traverse, rebuild,
  maybe_rebuild, repack, range_agg,
  search/insert/delete_batch                               (single shard)
  SearchEngine, get_engine, Probe, BACKENDS, with_backend  (descent backends)
  from_numpy_leaves, to_numpy_leaves, flat_leaves,
  from_flat_leaves, leaf_spec                              (state transfer)
  RefIndex                                                 (oracle)
"""
from repro_torch.core.batch import SEARCH, INSERT, DELETE, RANGE
from repro_torch.core.engine import BACKENDS, Probe, SearchEngine, get_engine
from repro_torch.core.index import (
    PIConfig, PIIndex, build, empty, execute, execute_impl, flat_leaves,
    from_flat_leaves, from_numpy_leaves, incremental_fits, leaf_spec,
    live_items, lookup, traverse, range_agg, rebuild, rebuild_tier,
    maybe_rebuild, needs_rebuild, repack,
    search_batch, insert_batch, delete_batch, to_numpy_leaves,
    validate_layout, with_backend,
)
from repro_torch.core.ref import RefIndex

__all__ = [
    "SEARCH", "INSERT", "DELETE", "RANGE", "PIConfig", "PIIndex", "build",
    "empty", "execute", "execute_impl", "flat_leaves", "from_flat_leaves",
    "from_numpy_leaves", "incremental_fits", "leaf_spec", "live_items",
    "lookup", "traverse", "range_agg",
    "rebuild",
    "rebuild_tier", "maybe_rebuild", "needs_rebuild", "repack",
    "search_batch", "insert_batch", "delete_batch", "to_numpy_leaves",
    "validate_layout", "with_backend",
    "SearchEngine", "get_engine", "Probe", "BACKENDS",
    "RefIndex",
]
