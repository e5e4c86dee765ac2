"""The system under test: ``repro_torch``'s served path, built from a
configuration file.

The only module of the benchmark that imports the program.  It builds the
index (one shard, or S fence-routed shards on one card) from the loaded
records the harness made, puts a ``Dispatcher`` over it and a
``Collector`` in front, and reads back what the program holds when the
run is over.
"""
from __future__ import annotations

import dataclasses

import torch

from pibench import ycsb
from repro_torch import core as pi
from repro_torch.core import batch as program_ops
from repro_torch.core.distributed import (ShardedPIIndex, build_sharded,
                                          make_mesh)
from repro_torch.kernels.pi_search import sentinel_for
from repro_torch.pipeline import (Collector, DispatchOverflowError,
                                  Dispatcher, PendingOverflowError,
                                  WindowConfig)

# the program's failures that a run reports as such, not as a crash
PROGRAM_ERRORS = (PendingOverflowError, DispatchOverflowError)

if (program_ops.SEARCH, program_ops.INSERT, program_ops.DELETE,
        program_ops.RANGE) != (ycsb.SEARCH, ycsb.INSERT, ycsb.DELETE,
                               ycsb.RANGE):
    raise ImportError("the program's op codes differ from the benchmark's")


@dataclasses.dataclass
class System:
    collector: Collector
    dispatcher: Dispatcher


def pi_config(config: dict) -> pi.PIConfig:
    """One shard's geometry."""
    return pi.PIConfig(capacity=config["capacity"],
                       pending_capacity=config["pending_capacity"],
                       fanout=config["fanout"], key_dtype=config["key_dtype"],
                       rebuild_frac=config["rebuild_frac"], backend="cuda")


def build(config: dict, keys: torch.Tensor, vals: torch.Tensor) -> System:
    """The served path over the loaded records ``keys``/``vals`` (int32
    tensors on the device the index is to live on)."""
    cfg = pi_config(config)
    shards = config["shards"]
    mesh = None
    if shards == 1:
        index = pi.build(cfg, keys, vals, device=keys.device)
    else:
        # build_sharded sorts on the host: hand it sorted keys
        sk, order = torch.sort(keys)
        index = build_sharded(cfg, shards, sk.cpu().numpy(),
                              vals[order].cpu().numpy(), device=keys.device)
        del sk, order
        mesh = make_mesh((shards,), ("data",), device=keys.device)
    disp = Dispatcher(index, mesh=mesh, depth=1,
                      capacity_factor=config.get("capacity_factor", 2.0),
                      max_span=config["max_span"])
    col = Collector(WindowConfig(batch=config["window"],
                                 key_dtype=config["key_dtype"]))
    return System(col, disp)


def fences(system: System):
    """The fence keys of a sharded index (None on one shard)."""
    index = system.dispatcher.index
    if isinstance(index, ShardedPIIndex):
        return index.fences.cpu().numpy()
    return None


def live_set(system: System):
    """The program's live (keys, values) after the run, sorted by key: the
    storage layer's occupied, untombstoned slots and the pending buffer's
    live prefix, of every shard.  Keys as int64 (a float32 key floored)."""
    index = system.dispatcher.index
    leaves = index.shards if isinstance(index, ShardedPIIndex) else index
    keys, vals, tomb = leaves.keys, leaves.vals, leaves.tomb
    pk, pv, pt, pn = leaves.pkeys, leaves.pvals, leaves.ptomb, leaves.pn
    if keys.dim() == 1:
        keys, vals, tomb = keys[None], vals[None], tomb[None]
        pk, pv, pt, pn = pk[None], pv[None], pt[None], pn.reshape(1)
    sent = sentinel_for(keys.dtype)
    main = (keys != sent) & ~tomb
    pidx = torch.arange(pk.shape[-1], device=pk.device)
    pend = (pidx[None] < pn[:, None]) & ~pt
    k = torch.cat([keys[main], pk[pend]])
    v = torch.cat([vals[main], pv[pend]])
    k = k.floor().long() if k.dtype.is_floating_point else k.long()
    k, order = torch.sort(k)
    return k, v[order].long()
