"""ShardedPIIndex — the paper's NUMA-aware partitioning, over ranks.

Counterpart of ``repro.core.distributed``, held to it bit for bit.  Paper
§4.3.1: the key space is range-partitioned across NUMA nodes; each node
builds an independent sub-index from its own keys; queries are routed to
the owning node and processed entirely in local memory.

Mapping:

* NUMA node      → a shard: a ``PIIndex`` whose leaves carry a leading
                   shard dimension, in the JAX leaf order (``levels`` a
                   tuple of (L, n_l) tensors).  S shards lie on P ranks
                   (S % P == 0), one process a rank along the mesh's
                   ``data`` axis; rank r holds the L = S/P shards
                   [r L, (r+1) L) on its device.  P = 1 is the one-card
                   layout, S = P the reference's one shard a device.
* query routing  → every rank runs the same host program on the same
                   global batch, as multi-controller JAX does; a rank
                   routes the slices of its L source shards: bucketize by
                   fence keys, then a dest-major, key-minor stable sort
                   into ``cap``-slot send buckets — the body of the JAX
                   ``_local_execute``
* ``all_to_all`` → one ``all_to_all_single`` each way on the axis's
                   process group, the three operand buffers packed as
                   int32 words (a float32 key travels as its bits); each
                   destination shard receives its lanes in global
                   (source, rank) order, the order ``shard_map``'s
                   ``all_to_all`` gives.  With P = 1 and no process group
                   the exchange is a transpose on the card.
* shard-local execution → ``core.index.execute_impl`` on each local
                   shard's S * cap lanes (on the ``cuda`` backend: one
                   ``bitonic_argsort`` and one ``pi_probe`` a shard a
                   window)
* results        → ``found``, ``val``, ``load`` and ``dropped`` are
                   gathered (one ``all_gather``), so that every rank holds
                   them whole, as JAX returns global arrays; so are the
                   rebuild flags and ``collect_pairs``' pairs
* self-adjusted threading → capacity-factored dispatch + fence rebalancing
                   (``core.rebalance``) over the gathered loads

A ``Mesh`` here names the shard axes and the device; with a
``DeviceMesh`` (``launch.mesh``) it also names the ranks.  Like
``execute_impl``, nothing here writes to the tensors of its input state.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import index as pi
from repro_torch.core.batch import SEARCH
from repro_torch.kernels.pi_search import sentinel_for, torch_dtype
from repro_torch.sharding import (group_all_gather, group_all_to_all,
                                  group_rank, group_size)

_I32 = torch.int32


# ---------------------------------------------------------------------------
# the mesh: S shards on P ranks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of shards on ``device``; with ``device_mesh`` (a
    ``torch.distributed`` ``DeviceMesh`` of the same axis names) the
    shards of an axis are spread over that axis's ranks."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    device_mesh: Optional[object] = None

    @property
    def shape(self) -> dict:
        """Axis name → shard count, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    def group(self, axis_name: str):
        """The process group of ``axis_name`` (None: one rank, no
        process group)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis_name)

    def ranks(self, axis_name: str) -> int:
        """How many ranks ``axis_name``'s shards are spread over."""
        if self.device_mesh is None:
            return 1
        names = tuple(self.device_mesh.mesh_dim_names)
        return int(self.device_mesh.size(names.index(axis_name)))


def make_mesh(axis_shapes, axis_names, device=None,
              device_mesh=None) -> Mesh:
    """A mesh of ``axis_shapes`` shards on ``device`` (default: the card).

    ``device_mesh`` spreads each axis's shards over that axis's ranks;
    every axis must then be one of its axes, with a shard count that its
    rank count divides.  ``device`` may be one device or a sequence that
    names one; a sequence of several devices is several ranks, which a
    ``device_mesh`` over an initialized process group names instead
    (``ValueError``).
    """
    if isinstance(device, (list, tuple)):
        devices = {torch.device(d) for d in device}
        if len(devices) > 1:
            raise ValueError(
                f"a mesh over {len(devices)} devices is one process a "
                f"device: initialize the torch.distributed process group "
                f"and pass device_mesh=launch.mesh.make_mesh(...) with "
                f"this process's device")
        device = next(iter(devices), None)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} axis sizes for "
                         f"{len(axis_names)} axis names")
    mesh = Mesh(tuple(int(s) for s in axis_shapes), tuple(axis_names),
                pi._device(device), device_mesh)
    for name, size in mesh.shape.items():
        if device_mesh is not None and size % mesh.ranks(name):
            raise ValueError(f"axis {name!r}: {size} shards do not divide "
                             f"over {mesh.ranks(name)} ranks")
    return mesh


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
    """This rank's stacked shards + replicated fence keys.

    ``shards`` leaves have leading dim L = S / P, the rank's shards
    [rank * L, (rank + 1) * L) of the S = ``n_shards``; ``group`` is the
    process group of the P ranks (None: P = 1).  ``fences`` has S+1
    entries with fences[0] = dtype.min and fences[S] = sentinel.  Shard s
    owns keys in [fences[s], fences[s+1]).
    """

    shards: pi.PIIndex          # stacked: every leaf (L, ...)
    fences: torch.Tensor        # (S+1,)
    n_shards: int
    group: Optional[object] = None

    @property
    def device(self) -> torch.device:
        return self.shards.device

    @property
    def n_ranks(self) -> int:
        return group_size(self.group)

    @property
    def first(self) -> int:
        """The global index of this rank's first shard."""
        return group_rank(self.group) * (self.n_shards // self.n_ranks)

    def live_count(self) -> torch.Tensor:
        """(S,) live keys per shard, gathered from every rank."""
        sh = self.shards
        sent = sentinel_for(sh.keys.dtype)
        main = ((sh.keys != sent) & ~sh.tomb).sum(-1)
        pidx = torch.arange(sh.pkeys.shape[-1], device=self.device)
        local = main + ((pidx < sh.pn[:, None]) & ~sh.ptomb).sum(-1)
        return group_all_gather(local, self.group).reshape(-1)


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


def gather_shards(shards: pi.PIIndex, group) -> pi.PIIndex:
    """Every rank's stacked shards as one index of S stacked shards (on
    every rank), leaf by leaf in ``PIIndex.tree_flatten`` order."""
    if group is None:
        return shards
    return pi.from_flat_leaves(
        shards.config,
        [group_all_gather(x, group).flatten(0, 1)
         for x in pi.flat_leaves(shards)])


def local_block(x, n_shards: int, group):
    """This rank's block of a leading dim of S entries."""
    if group is None:
        return x
    L = n_shards // group_size(group)
    r = group_rank(group)
    return x[r * L:(r + 1) * L]


def build_sharded(cfg: pi.PIConfig, n_shards: int, keys, vals,
                  fences=None, device=None, mesh: Optional[Mesh] = None,
                  axis_name: str = "data") -> ShardedPIIndex:
    """Host-side build: partition by fences (default: equi-depth) and
    stack, on ``device`` (default: the mesh's, else the card).  With a
    ``mesh`` over ranks, every rank gives the same keys and builds only
    its own shards."""
    group = mesh.group(axis_name) if mesh is not None else None
    dev = mesh.device if mesh is not None and device is None \
        else pi._device(device)
    P = group_size(group)
    if n_shards % P:
        raise ValueError(f"{n_shards} shards do not divide over {P} ranks")
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
    L = n_shards // P
    first = group_rank(group) * L
    parts = []
    for s in range(first, first + L):
        m = (keys >= fences[s]) & (keys < fences[s + 1]) if s + 1 < n_shards \
            else (keys >= fences[s])
        parts.append(pi.build(cfg, keys[m], vals[m], device=dev))
    return ShardedPIIndex(shards=stack_shards(parts),
                          fences=torch.from_numpy(fences).to(dev),
                          n_shards=n_shards, group=group)


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

def _as_words(x: torch.Tensor) -> torch.Tensor:
    """A 4-byte tensor as int32 words (a float32 key keeps its bits)."""
    return x if x.dtype == _I32 else x.view(_I32)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """The all_to_all of stacked buffers ``(k, L_src, S, cap)`` →
    ``(k, L_dst, S, cap)``: local source l's bucket for destination d
    reaches d's rank, where the S source buckets of each destination
    stand in global source order (rank-major, as ``shard_map`` puts
    them).  Used both ways: results go back by the same exchange."""
    k, L, S, cap = x.shape
    P = group_size(group)
    # (k, L_src, P, L_dst, cap) → one block per destination rank
    send = x.reshape(k, L, P, S // P, cap).permute(2, 0, 1, 3, 4)
    recv = group_all_to_all(send, group)    # (P_src, k, L_src, L_dst, cap)
    return recv.permute(1, 3, 0, 2, 4).reshape(k, S // P, S, cap)


def _execute_routed(shards: pi.PIIndex, fences, ops, qkeys, qvals, cap: int,
                    n_shards: int, group=None):
    """The rank's source shards' slices routed as ``_local_execute``
    routes them, its destination shards executed, the results routed
    back and gathered.

    Returns ``(new_shards, found, val, load, dropped)``, the last four
    global on every rank: ``load[d]`` the real queries shard d received,
    ``dropped[s]`` the real queries of source s that overflowed a bucket
    (sentinel padding routes to the last shard and sorts after the real
    keys there, so it is evicted first and its loss is not counted).
    """
    S = n_shards
    P = group_size(group)
    L = S // P
    kdt = shards.keys.dtype
    sent = sentinel_for(kdt)
    b = ops.shape[0] // S
    ops, qkeys, qvals = (local_block(x.reshape(S, b), S, group)
                         for x in (ops, qkeys, qvals))
    k = qkeys.to(kdt)

    # --- outbound routing (paper: route query to owning NUMA node) --------
    dest = torch.searchsorted(fences[1:-1].contiguous(), k, right=True,
                              out_int32=True).clamp(0, S - 1)
    order, slot, keep, _ = dispatch_plan(dest, S, cap, sort_key=qkeys)
    n_drop = (~keep & (torch.take_along_dim(k, order.long(), -1) != sent)) \
        .sum(-1, dtype=_I32)
    send = torch.stack([
        scatter_to_buffer(ops, order, slot, S, cap, SEARCH),
        _as_words(scatter_to_buffer(k, order, slot, S, cap, sent)),
        scatter_to_buffer(qvals, order, slot, S, cap, 0)])
    # where each slot came from, so that results can return: the query in
    # slot[i] is sorted item i == original index order[i]
    src_pos = torch.full((L, S * cap + 1), -1, dtype=_I32,
                         device=ops.device)
    src_pos.scatter_(-1, slot.long(), order)
    src_pos = src_pos[:, :S * cap]

    # --- the all_to_all ---------------------------------------------------
    recv = _exchange(send, group).reshape(3, L, S * cap)
    recv_ops, recv_keys, recv_vals = recv[0], recv[1].view(kdt), recv[2]

    # --- local execution: no shard reads another's state -----------------
    views = [shard_of(shards, d) for d in range(L)]
    parts, found, val = [], [], []
    for d in range(L):
        new, (f, v) = pi.execute_impl(views[d], recv_ops[d], recv_keys[d],
                                      recv_vals[d])
        parts.append(new)
        found.append(f)
        val.append(v)

    # --- inbound routing of results ---------------------------------------
    back = _exchange(torch.stack([torch.stack(found).to(_I32),
                                  torch.stack(val)]).reshape(2, L, S, cap),
                     group).reshape(2, L, S * cap)
    tgt = torch.where(src_pos >= 0, src_pos, b).long()
    out = torch.zeros((2, L, b + 1), dtype=_I32, device=ops.device)
    out.scatter_(-1, tgt.expand(2, L, S * cap), back)
    # per-shard load (for self-adjusted rebalancing)
    load = (recv_keys != sent).sum(-1, dtype=_I32)
    new_shards = stack_shards(parts, views, shards)
    if group is None:
        return (new_shards, out[0, :, :b].reshape(-1).bool(),
                out[1, :, :b].reshape(-1), load, n_drop)
    # one gather: found, val, load, dropped of every rank
    mine = torch.cat([out[:, :, :b].reshape(-1), load, n_drop])
    every = group_all_gather(mine, group)              # (P, 2Lb + 2L)
    res = every[:, :2 * L * b].reshape(P, 2, L * b).transpose(0, 1) \
        .reshape(2, S * b)
    load = every[:, 2 * L * b:2 * L * b + L].reshape(S)
    n_drop = every[:, 2 * L * b + L:].reshape(S)
    return new_shards, res[0].bool(), res[1], load, n_drop


def make_sharded_executor(mesh: Mesh, cfg: pi.PIConfig, batch_per_shard: int,
                          axis_name: str = "data",
                          capacity_factor: float = 2.0):
    """The batch executor of a mesh → ``(run, cap)``.

    ``run(shards, fences, ops, keys, vals) -> (shards', found, vals, load,
    dropped)`` where ops/keys/vals are global (S * batch_per_shard,)
    tensors, source shard s owning the slice [s*b, (s+1)*b), and
    ``shards`` this rank's.  ``cap`` is the send-bucket size: a source
    sends at most ``cap`` queries to each destination.
    """
    S = mesh.shape[axis_name]
    group = mesh.group(axis_name)
    # integer-exact ceil: the factor is frozen to a /1024 rational so the
    # lane budget cannot wobble with float rounding
    num = int(round(capacity_factor * 1024))
    cap = -(-batch_per_shard * num // (S * 1024))

    def run(shards, fences, ops, qkeys, qvals):
        return _execute_routed(shards, fences, ops, qkeys, qvals, cap, S,
                               group)

    return run, cap


def execute_sharded(state: ShardedPIIndex, mesh: Mesh, ops, qkeys, qvals,
                    axis_name: str = "data", capacity_factor: float = 2.0):
    """One global batch through the mesh → ``(new_state, (found, val),
    load, dropped)``, every output global on every rank; the inputs move
    to the state's device."""
    S = state.n_shards
    if mesh.shape[axis_name] != S:
        raise ValueError(f"mesh axis {axis_name!r} has "
                         f"{mesh.shape[axis_name]} shards, the index {S}")
    if mesh.device.type != state.device.type:
        raise ValueError(f"mesh on {mesh.device}, index on {state.device}")
    if mesh.ranks(axis_name) != state.n_ranks:
        raise ValueError(f"mesh axis {axis_name!r} spans "
                         f"{mesh.ranks(axis_name)} ranks, the index "
                         f"{state.n_ranks}")
    dev = state.device
    ops, qkeys, qvals = (torch.as_tensor(x).to(dev) for x in
                         (ops, qkeys, qvals))
    B = ops.shape[0]
    assert B % S == 0, "global batch must divide the shard count"
    run, _ = make_sharded_executor(mesh, state.shards.config, B // S,
                                   axis_name, capacity_factor)
    shards, found, val, load, dropped = run(state.shards, state.fences, ops,
                                            qkeys, qvals)
    new_state = dataclasses.replace(state, shards=shards)
    return new_state, (found, val), load, dropped


# ---------------------------------------------------------------------------
# rebuilds (per shard; the paper's daemon, §4.1)
# ---------------------------------------------------------------------------

def rebuild_sharded(state: ShardedPIIndex) -> ShardedPIIndex:
    """Per-shard deferred rebuild of every local shard."""
    n_local = state.shards.keys.shape[0]
    views = [shard_of(state.shards, s) for s in range(n_local)]
    shards = stack_shards([pi.rebuild(v) for v in views])
    return dataclasses.replace(state, shards=shards)


def rebuild_due(shards: pi.PIIndex, group=None, extra=None):
    """``maybe_rebuild_shards`` that also gathers ``extra`` (an int32
    vector of this rank's own values) in the same gather → ``(shards,
    any_overflow, any_due, extra of every rank)``, the last three read on
    the host (``extra`` as one list a rank)."""
    L = shards.keys.shape[0]
    mine = [shards.overflow.any().to(_I32)[None],
            pi.needs_rebuild(shards).to(_I32)]
    if extra is not None:
        mine.append(extra.to(_I32))
    # the one host read, of every rank's flags: every rank takes the
    # same branch
    every = group_all_gather(torch.cat(mine), group).tolist()
    due = [row[1:1 + L] for row in every]
    any_due = any(map(any, due))
    if any_due:
        views = [shard_of(shards, s) for s in range(L)]
        parts = [pi.rebuild(v) if d else v
                 for v, d in zip(views, due[group_rank(group)])]
        shards = stack_shards(parts, views, shards)
    return (shards, any(row[0] for row in every), any_due,
            [row[1 + L:] for row in every])


def maybe_rebuild_shards(shards: pi.PIIndex, group=None):
    """Per-shard dirty-tracked daemon on stacked shard leaves.

    Rebuilds only the shards that are due (``needs_rebuild``, evaluated
    for the rank's shards at once, the flags of every rank gathered and
    read on the host once, so that every rank takes the same branch); a
    shard that is not due keeps its state, pending churn included.
    Returns ``(shards, any_overflow, any_due)`` over every rank; the
    overflow flag is taken *before* the rebuild resets it on the state
    (overflow is data loss and must stay observable).
    """
    shards, ovf, due, _ = rebuild_due(shards, group)
    return shards, ovf, due


def maybe_rebuild_sharded(state: ShardedPIIndex) -> ShardedPIIndex:
    """State-level wrapper of ``maybe_rebuild_shards``."""
    shards, _, _ = maybe_rebuild_shards(state.shards, state.group)
    return dataclasses.replace(state, shards=shards)


def _gather_ragged(x: np.ndarray, group, device) -> np.ndarray:
    """Every rank's 1-D array, concatenated in rank order."""
    if group is None:
        return x
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    sizes = group_all_gather(torch.tensor([t.numel()], device=device),
                             group).reshape(-1).tolist()
    pad = torch.zeros(max(sizes), dtype=t.dtype, device=device)
    pad[:t.numel()] = t
    every = group_all_gather(pad, group).cpu().numpy()
    return np.concatenate([every[i, :n] for i, n in enumerate(sizes)])


def collect_pairs(state: ShardedPIIndex):
    """Host-side: all live (key, val) pairs sorted by key (numpy), from
    every rank, for resharding and tests."""
    ks, vs = [], []
    for s in range(state.shards.keys.shape[0]):
        k, v = pi.live_items(shard_of(state.shards, s))
        ks.append(k)
        vs.append(v)
    k = _gather_ragged(np.concatenate(ks), state.group, state.device)
    v = _gather_ragged(np.concatenate(vs), state.group, state.device)
    order = np.argsort(k)
    return k[order], v[order]
