"""ShardedPIIndex — the paper's NUMA-aware partitioning, on one card.

Counterpart of ``repro.core.distributed``, held to it bit for bit.  Paper
§4.3.1: the key space is range-partitioned across NUMA nodes; each node
builds an independent sub-index from its own keys; queries are routed to
the owning node and processed entirely in local memory.

Mapping onto one device:

* NUMA node      → a shard: a ``PIIndex`` whose leaves carry a leading
                   shard dimension S, in the JAX leaf order (``levels`` a
                   tuple of (S, n_l) tensors)
* query routing  → bucketize by fence keys, then a dest-major, key-minor
                   stable sort into ``cap``-slot send buckets — the body
                   of the JAX ``_local_execute``, run for every source
                   shard's slice of the global batch at once
* ``all_to_all`` → a transpose of the stacked send buffers, (S_src, S_dst,
                   cap) → (S_dst, S_src, cap), so that destination d runs
                   its lanes in (source, rank) order as under ``shard_map``;
                   results return by the inverse transpose and a scatter to
                   each query's source position
* shard-local execution → ``core.index.execute_impl`` on each shard's
                   S * cap lanes, in a Python loop over the shards (on the
                   ``cuda`` backend: one ``bitonic_argsort`` and one
                   ``pi_probe`` a shard a window)
* self-adjusted threading → capacity-factored dispatch + fence rebalancing
                   (``core.rebalance``)

A ``Mesh`` here is S shards on one device along one named axis
(``make_mesh``).  Shards across several cards need an ``all_to_all`` over
``torch.distributed`` (ROADMAP A9), and a mesh over more than one device
is refused.  Like ``execute_impl``, nothing here writes to the tensors of
its input state.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import index as pi
from repro_torch.core.batch import SEARCH
from repro_torch.kernels.pi_search import sentinel_for, torch_dtype

_I32 = torch.int32

MULTI_DEVICE = ("a mesh over more than one device needs an all_to_all over "
                "torch.distributed, not ported yet (ROADMAP A9, multi-GPU)")


# ---------------------------------------------------------------------------
# the mesh: S shards on one device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of shards that all live on ``device``."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device

    @property
    def shape(self) -> dict:
        """Axis name → size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


def make_mesh(axis_shapes, axis_names, device=None) -> Mesh:
    """A mesh of ``axis_shapes`` shards on ``device`` (default: the card).

    ``device`` may be one device or a sequence of them; a sequence that
    names more than one device raises ``NotImplementedError``.
    """
    if isinstance(device, (list, tuple)):
        devices = {torch.device(d) for d in device}
        if len(devices) > 1:
            raise NotImplementedError(MULTI_DEVICE)
        device = next(iter(devices), None)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} axis sizes for "
                         f"{len(axis_names)} axis names")
    return Mesh(tuple(int(s) for s in axis_shapes), tuple(axis_names),
                pi._device(device))


# ---------------------------------------------------------------------------
# generic sorted dispatch
# ---------------------------------------------------------------------------

def dispatch_plan(dest: torch.Tensor, n_dest: int, cap: int,
                  sort_key: torch.Tensor | None = None):
    """Plan a capacity-bounded dispatch of local items to ``n_dest`` buckets.

    Items are stably sorted by (dest, sort_key) — the paper's sorted query
    batch — then the first ``cap`` items of each destination group survive;
    the rest overflow.  Works along the last axis: leading axes are
    independent batches (one a source shard).

    Returns (order, slot, keep, n_dropped), ``order`` and ``slot`` int32:
      order : (..., B) permutation applied before bucketing
      slot  : (..., B) position of sorted item i in its send buffer
              (dest*cap + rank; n_dest*cap when dropped)
      keep  : (..., B) mask of items that fit
    """
    B = dest.shape[-1]
    if sort_key is not None:
        # dest-major, key-minor: two-pass stable argsort
        o1 = torch.argsort(sort_key, dim=-1, stable=True)
        o2 = torch.argsort(torch.take_along_dim(dest, o1, -1), dim=-1,
                           stable=True)
        order = torch.take_along_dim(o1, o2, -1)
    else:
        order = torch.argsort(dest, dim=-1, stable=True)
    d_sorted = torch.take_along_dim(dest, order, -1).to(_I32).contiguous()
    # rank within destination group: each group's start is a searchsorted
    # of the group id against the sorted ids themselves
    idx = torch.arange(B, dtype=_I32, device=dest.device)
    rank = idx - torch.searchsorted(d_sorted, d_sorted, out_int32=True)
    keep = rank < cap
    slot = torch.where(keep, d_sorted * cap + rank, n_dest * cap)
    n_dropped = (~keep).sum(-1, dtype=_I32)
    return order.to(_I32), slot, keep, n_dropped


def scatter_to_buffer(arr: torch.Tensor, order: torch.Tensor,
                      slot: torch.Tensor, n_dest: int, cap: int,
                      fill) -> torch.Tensor:
    """(..., B) → (..., n_dest, cap) send buffer; dropped items vanish."""
    n = n_dest * cap
    lead = order.shape[:-1]
    buf = torch.full(lead + (n + 1,), fill, dtype=arr.dtype,
                     device=arr.device)
    # dropped items all land on the spare slot n, which is cut off
    buf.scatter_(-1, slot.long(),
                 torch.take_along_dim(arr, order.long(), -1))
    return buf[..., :n].reshape(lead + (n_dest, cap))


# ---------------------------------------------------------------------------
# sharded index state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedPIIndex:
    """Stacked per-shard PIIndex + replicated fence keys.

    ``shards`` leaves have leading dim S (the data-axis size); ``fences``
    has S+1 entries with fences[0] = dtype.min and fences[S] = sentinel.
    Shard s owns keys in [fences[s], fences[s+1]).
    """

    shards: pi.PIIndex          # stacked: every leaf (S, ...)
    fences: torch.Tensor        # (S+1,)
    n_shards: int

    @property
    def device(self) -> torch.device:
        return self.shards.device

    def live_count(self) -> torch.Tensor:
        """(S,) live keys per shard."""
        sh = self.shards
        sent = sentinel_for(sh.keys.dtype)
        main = ((sh.keys != sent) & ~sh.tomb).sum(-1)
        pidx = torch.arange(sh.pkeys.shape[-1], device=self.device)
        return main + ((pidx < sh.pn[:, None]) & ~sh.ptomb).sum(-1)


def shard_of(shards: pi.PIIndex, s: int) -> pi.PIIndex:
    """Shard ``s`` of stacked leaves, as a ``PIIndex`` of views."""
    return pi.from_flat_leaves(shards.config,
                               [x[s] for x in pi.flat_leaves(shards)])


def stack_shards(parts, views=None, stacked=None) -> pi.PIIndex:
    """Stack per-shard indexes into one of stacked leaves.  A leaf that
    every part still shares with ``views`` (the shards of ``stacked`` they
    came from) is taken from ``stacked`` as it is, without a copy."""
    cols = zip(*(pi.flat_leaves(p) for p in parts))
    shared = zip(*(pi.flat_leaves(v) for v in views)) if views else None
    old = pi.flat_leaves(stacked) if stacked is not None else None
    out = []
    for j, col in enumerate(cols):
        was = next(shared) if shared is not None else None
        if was is not None and all(c is w for c, w in zip(col, was)):
            out.append(old[j])
        else:
            out.append(torch.stack(col))
    return pi.from_flat_leaves(parts[0].config, out)


def build_sharded(cfg: pi.PIConfig, n_shards: int, keys, vals,
                  fences=None, device=None) -> ShardedPIIndex:
    """Host-side build: partition by fences (default: equi-depth) and
    stack, on ``device`` (default: the card)."""
    dev = pi._device(device)
    keys = np.asarray(keys)
    vals = np.asarray(vals)
    order = np.argsort(keys)
    keys, vals = keys[order], vals[order]
    kdt = np.dtype(cfg.key_dtype)
    if fences is None:
        # equi-depth split of the initial data (paper: even distribution)
        cuts = [keys[(len(keys) * s) // n_shards]
                for s in range(1, n_shards)] if len(keys) \
            else [0] * (n_shards - 1)
        lo = np.iinfo(kdt).min if np.issubdtype(kdt, np.integer) else -np.inf
        hi = sentinel_for(kdt)    # top fence == the engine pad key
        fences = np.array([lo, *cuts, hi], dtype=kdt)
    fences = np.asarray(fences, dtype=kdt)
    parts = []
    for s in range(n_shards):
        m = (keys >= fences[s]) & (keys < fences[s + 1]) if s + 1 < n_shards \
            else (keys >= fences[s])
        parts.append(pi.build(cfg, keys[m], vals[m], device=dev))
    return ShardedPIIndex(shards=stack_shards(parts),
                          fences=torch.from_numpy(fences).to(dev),
                          n_shards=n_shards)


def leaf_spec_sharded(cfg: pi.PIConfig, n_shards: int):
    """``(shards, fences)`` of ``n_shards`` shards of ``cfg`` on the
    ``meta`` device: shapes and dtypes, no storage.  What a sharded
    snapshot is restored into (``pipeline.recovery.recover``)."""
    one = pi.flat_leaves(pi.leaf_spec(cfg))
    shards = pi.from_flat_leaves(
        cfg, [x.expand((n_shards,) + x.shape) for x in one])
    fences = torch.empty((n_shards + 1,), dtype=torch_dtype(cfg.key_dtype),
                         device="meta")
    return shards, fences


# ---------------------------------------------------------------------------
# routing → execution → routing back
# ---------------------------------------------------------------------------

def _execute_routed(shards: pi.PIIndex, fences, ops, qkeys, qvals, cap: int,
                    n_shards: int):
    """Every source shard's slice routed as ``_local_execute`` routes it,
    each destination shard executed, the results routed back.

    Returns ``(new_shards, found, val, load, dropped)``: ``load[d]`` the
    real queries shard d received, ``dropped[s]`` the real queries of
    source s that overflowed a bucket (sentinel padding routes to the
    last shard and sorts after the real keys there, so it is evicted
    first and its loss is not counted).
    """
    S = n_shards
    kdt = shards.keys.dtype
    sent = sentinel_for(kdt)
    b = ops.shape[0] // S
    ops, qkeys, qvals = (x.reshape(S, b) for x in (ops, qkeys, qvals))
    k = qkeys.to(kdt)

    # --- outbound routing (paper: route query to owning NUMA node) --------
    dest = torch.searchsorted(fences[1:-1].contiguous(), k, right=True,
                              out_int32=True).clamp(0, S - 1)
    order, slot, keep, _ = dispatch_plan(dest, S, cap, sort_key=qkeys)
    n_drop = (~keep & (torch.take_along_dim(k, order.long(), -1) != sent)) \
        .sum(-1, dtype=_I32)
    send_ops = scatter_to_buffer(ops, order, slot, S, cap, SEARCH)
    send_keys = scatter_to_buffer(k, order, slot, S, cap, sent)
    send_vals = scatter_to_buffer(qvals, order, slot, S, cap, 0)
    # where each slot came from, so that results can return: the query in
    # slot[i] is sorted item i == original index order[i]
    src_pos = torch.full((S, S * cap + 1), -1, dtype=_I32,
                         device=ops.device)
    src_pos.scatter_(-1, slot.long(), order)
    src_pos = src_pos[:, :S * cap]

    # --- the all_to_all: (S_src, S_dst, cap) → (S_dst, S_src, cap) ---------
    def a2a(x):
        return x.transpose(0, 1).reshape(S, S * cap)

    recv_ops, recv_keys, recv_vals = (a2a(x) for x in
                                      (send_ops, send_keys, send_vals))

    # --- local execution: no shard reads another's state -----------------
    views = [shard_of(shards, d) for d in range(S)]
    parts, found, val = [], [], []
    for d in range(S):
        new, (f, v) = pi.execute_impl(views[d], recv_ops[d], recv_keys[d],
                                      recv_vals[d])
        parts.append(new)
        found.append(f)
        val.append(v)

    # --- inbound routing of results ---------------------------------------
    def back(xs):
        return torch.stack(xs).reshape(S, S, cap).transpose(0, 1) \
            .reshape(S, S * cap)

    tgt = torch.where(src_pos >= 0, src_pos, b).long()
    out_found = torch.zeros((S, b + 1), dtype=torch.bool, device=ops.device)
    out_val = torch.zeros((S, b + 1), dtype=_I32, device=ops.device)
    out_found.scatter_(-1, tgt, back(found))
    out_val.scatter_(-1, tgt, back(val))
    # per-shard load (for self-adjusted rebalancing)
    load = (recv_keys != sent).sum(-1, dtype=_I32)
    return (stack_shards(parts, views, shards), out_found[:, :b].reshape(-1),
            out_val[:, :b].reshape(-1), load, n_drop)


def make_sharded_executor(mesh: Mesh, cfg: pi.PIConfig, batch_per_shard: int,
                          axis_name: str = "data",
                          capacity_factor: float = 2.0):
    """The batch executor of a mesh → ``(run, cap)``.

    ``run(shards, fences, ops, keys, vals) -> (shards', found, vals, load,
    dropped)`` where ops/keys/vals are global (S * batch_per_shard,)
    tensors, source shard s owning the slice [s*b, (s+1)*b).  ``cap`` is
    the send-bucket size: a source sends at most ``cap`` queries to each
    destination.
    """
    S = mesh.shape[axis_name]
    # integer-exact ceil: the factor is frozen to a /1024 rational so the
    # lane budget cannot wobble with float rounding
    num = int(round(capacity_factor * 1024))
    cap = -(-batch_per_shard * num // (S * 1024))

    def run(shards, fences, ops, qkeys, qvals):
        return _execute_routed(shards, fences, ops, qkeys, qvals, cap, S)

    return run, cap


def execute_sharded(state: ShardedPIIndex, mesh: Mesh, ops, qkeys, qvals,
                    axis_name: str = "data", capacity_factor: float = 2.0):
    """One global batch through the mesh → ``(new_state, (found, val),
    load, dropped)``; the inputs move to the state's device."""
    S = state.n_shards
    if mesh.shape[axis_name] != S:
        raise ValueError(f"mesh axis {axis_name!r} has "
                         f"{mesh.shape[axis_name]} shards, the index {S}")
    if mesh.device.type != state.device.type:
        raise ValueError(f"mesh on {mesh.device}, index on {state.device}")
    dev = state.device
    ops, qkeys, qvals = (torch.as_tensor(x).to(dev) for x in
                         (ops, qkeys, qvals))
    B = ops.shape[0]
    assert B % S == 0, "global batch must divide the shard count"
    run, _ = make_sharded_executor(mesh, state.shards.config, B // S,
                                   axis_name, capacity_factor)
    shards, found, val, load, dropped = run(state.shards, state.fences, ops,
                                            qkeys, qvals)
    new_state = ShardedPIIndex(shards=shards, fences=state.fences,
                               n_shards=S)
    return new_state, (found, val), load, dropped


# ---------------------------------------------------------------------------
# rebuilds (per shard; the paper's daemon, §4.1)
# ---------------------------------------------------------------------------

def rebuild_sharded(state: ShardedPIIndex) -> ShardedPIIndex:
    """Per-shard deferred rebuild of every shard."""
    views = [shard_of(state.shards, s) for s in range(state.n_shards)]
    shards = stack_shards([pi.rebuild(v) for v in views])
    return ShardedPIIndex(shards=shards, fences=state.fences,
                          n_shards=state.n_shards)


def maybe_rebuild_shards(shards: pi.PIIndex):
    """Per-shard dirty-tracked daemon on stacked shard leaves.

    Rebuilds only the shards that are due (``needs_rebuild``, evaluated
    for all shards at once and read on the host once); a shard that is
    not due keeps its state, pending churn included.  Returns ``(shards,
    any_overflow, any_due)``; the overflow flag is taken *before* the
    rebuild resets it on the state (overflow is data loss and must stay
    observable).
    """
    ovf = shards.overflow.any()
    due_each = pi.needs_rebuild(shards)
    due = due_each.any()
    due_host = due_each.cpu().tolist()
    if not any(due_host):
        return shards, ovf, due
    views = [shard_of(shards, s) for s in range(len(due_host))]
    parts = [pi.rebuild(v) if d else v for v, d in zip(views, due_host)]
    return stack_shards(parts, views, shards), ovf, due


def maybe_rebuild_sharded(state: ShardedPIIndex) -> ShardedPIIndex:
    """State-level wrapper of ``maybe_rebuild_shards``."""
    shards, _, _ = maybe_rebuild_shards(state.shards)
    return ShardedPIIndex(shards=shards, fences=state.fences,
                          n_shards=state.n_shards)


def collect_pairs(state: ShardedPIIndex):
    """Host-side: all live (key, val) pairs sorted by key (numpy), for
    resharding and tests."""
    ks, vs = [], []
    for s in range(state.n_shards):
        k, v = pi.live_items(shard_of(state.shards, s))
        ks.append(k)
        vs.append(v)
    k = np.concatenate(ks)
    v = np.concatenate(vs)
    order = np.argsort(k)
    return k[order], v[order]
