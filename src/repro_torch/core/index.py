"""PIIndex — the paper's two-layer skip-list index, on dense tensors.

Counterpart of ``repro.core.index``, held to it bit for bit: the same
layout, the same leaves in the same order, the same results.

* **Storage layer**: a *segmented gapped* key array (+ ``vals``, tombstone
  bitmap ``tomb``) of static capacity ``C = S * W``: ``S`` fixed-width
  segments of ``W`` slots, each a sorted run followed by ``KSENT`` slack.
  Deletes are tombstones, compacted at rebuild time (paper §3.2.3).
  Invariants L1-L5 (checked by ``validate_layout``):
    L1  every segment is a sorted run prefix + a KSENT slack tail;
    L2  runs are strictly increasing (keys unique);
    L3  runs are ordered across segments;
    L4  empty segments appear only at the global tail;
    L5  ``W`` is a power of the fanout ``F`` (or W == C, one segment).
* **Index layer**: ``levels[l-1]`` holds every ``F**l``-th storage key
  (l = 1..H); an entry's routing table is rank arithmetic.
* **Pending buffer**: sorted ``pkeys/pvals/ptomb`` of capacity ``PC``
  holds keys inserted since the last rebuild.

Devices: ``build``, ``empty`` and ``from_numpy_leaves`` put the index on
the card unless the caller passes ``device="cpu"``; they raise when no
card is present and never fall back.  Every other function follows the
device of the index's tensors.

Functional style: ``execute`` and the rebuilds return a new ``PIIndex``
and never write to the tensors of their input (the un-donated JAX
dispatcher behaves so, and a later breaker rollback relies on it).  They
do write in place to tensors they allocated themselves.

Host syncs: PyTorch runs eagerly, so where the JAX package branches with
``lax.cond`` inside one program (``rebuild``, ``maybe_rebuild``) the port
reads the predicate on the host — one device-to-host sync each.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.runtime import launch_guard
from repro_torch.core.batch import (SEARCH, INSERT, DELETE,
                                    seg_last_write_scan)
from repro_torch.core.engine import BACKENDS, get_engine
from repro_torch.kernels.pi_search import (gather_fill, sentinel_for,
                                           torch_dtype)

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class PIConfig:
    """Static geometry of one PI shard (same fields as the JAX package's).

    fanout F plays the role of both the promotion probability (P = 1/F)
    and the entry width M.  ``backend`` selects the search engine
    (``torch`` | ``cuda``); ``tile_q`` is kept for parity and unused by
    the CUDA kernels, which run one thread per query.
    """

    capacity: int = 1 << 16          # C  — max live+tombstoned storage slots
    pending_capacity: int = 1 << 12  # PC — max inserts between rebuilds
    fanout: int = 4                  # F  — keys per entry == 1/P
    key_dtype: str = "int32"
    rebuild_frac: float = 0.15       # paper: rebuild after 15% of N updates
    backend: str = "cuda"            # search engine: torch|cuda
    tile_q: int = 256
    seg_width: int = 0               # W — slots per gapped segment (0 = auto)
    max_dirty_frac: float = 0.25     # incremental rebuild cap: dirty/S ratio

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        if self.seg_width:
            w = self.seg_width
            if self.capacity % w:
                raise ValueError(
                    f"seg_width {w} must divide capacity {self.capacity}")
            if w != self.capacity:
                j = w
                while j > 1 and j % self.fanout == 0:
                    j //= self.fanout
                if j != 1 or w < self.fanout:
                    raise ValueError(
                        f"seg_width {w} must be a power of fanout "
                        f"{self.fanout} (invariant L5) or == capacity")

    @property
    def num_levels(self) -> int:
        """H: number of index-layer levels (levels 1..H above storage)."""
        h = 0
        size = self.capacity
        while size > self.fanout:
            size = -(-size // self.fanout)
            h += 1
        return h

    def level_size(self, lvl: int) -> int:
        size = self.capacity
        for _ in range(lvl):
            size = -(-size // self.fanout)
        return size

    @property
    def seg_width_eff(self) -> int:
        """W: the largest power of ``fanout`` <= min(256, capacity //
        fanout) that divides ``capacity``, unless ``seg_width`` is set; one
        capacity-wide segment when no such power exists."""
        if self.seg_width:
            return self.seg_width
        target = min(256, max(self.fanout, self.capacity // self.fanout))
        w = self.fanout
        while w * self.fanout <= target:
            w *= self.fanout
        while w >= self.fanout and self.capacity % w:
            w //= self.fanout
        return w if w >= self.fanout else self.capacity

    @property
    def num_segments(self) -> int:
        """S: segment count (C == S * W)."""
        return self.capacity // self.seg_width_eff

    @property
    def max_dirty(self) -> int:
        """D: static bound on segments one incremental rebuild may touch."""
        s = self.num_segments
        return max(1, min(s, int(s * self.max_dirty_frac)))


@dataclasses.dataclass
class PIIndex:
    """One PI shard; fields in the leaf order of the JAX ``tree_flatten``."""

    # storage layer (segmented gapped: S sorted runs + KSENT slack tails)
    keys: torch.Tensor   # (C,)  = (S*W,), invariants L1-L5
    vals: torch.Tensor   # (C,)  int32 value "pointers"
    tomb: torch.Tensor   # (C,)  bool F_del
    n: torch.Tensor      # ()    occupied (non-KSENT) slots: live + tombstoned
    # index layer (levels 1..H, contiguous per level)
    levels: Tuple[torch.Tensor, ...]
    # pending buffer (storage-layer inserts awaiting rebuild)
    pkeys: torch.Tensor  # (PC,) sorted, KSENT-padded
    pvals: torch.Tensor
    ptomb: torch.Tensor
    pn: torch.Tensor     # ()
    # bookkeeping
    n_updates: torch.Tensor  # () inserts+deletes since last rebuild
    overflow: torch.Tensor   # () bool — pending buffer overflowed (data loss!)
    config: PIConfig

    def leaves(self) -> tuple:
        """The state tensors in the JAX ``tree_flatten`` order."""
        return (self.keys, self.vals, self.tomb, self.n, self.levels,
                self.pkeys, self.pvals, self.ptomb, self.pn,
                self.n_updates, self.overflow)

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def live_count(self) -> torch.Tensor:
        sent = sentinel_for(self.keys.dtype)
        main = ((self.keys != sent) & ~self.tomb).sum()
        pidx = torch.arange(self.pkeys.shape[0], device=self.device)
        return main + ((pidx < self.pn) & ~self.ptomb).sum()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _device(device) -> torch.device:
    """The device an entry point builds on: the card unless asked."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build "
                           "the index on the CPU")
    return device


def _scalar(value, dtype, device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def _set_drop(base: torch.Tensor, idx: torch.Tensor,
              src: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``base`` with rows ``idx`` set to ``src``, where an
    index outside ``[0, len(base))`` drops its row — the counterpart of
    ``base.at[idx].set(src, mode="drop")``.  Dropped rows land on one spare
    row past the end, which is cut off; kept indices must be unique or
    carry equal values."""
    n = base.shape[0]
    out = torch.empty((n + 1,) + base.shape[1:], dtype=base.dtype,
                      device=base.device)
    out[:n] = base
    idx = idx.long()
    out[torch.where((idx >= 0) & (idx < n), idx, n)] = src
    return out[:n]


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def _build_levels(cfg: PIConfig, keys: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Index layer = every F**l-th storage key, per level, KSENT-filled
    (the paper's bottom-up O(N) rebuild, §4.1)."""
    sent = sentinel_for(keys.dtype)
    levels = []
    for lvl in range(1, cfg.num_levels + 1):
        src = torch.arange(cfg.level_size(lvl), device=keys.device) * \
            cfg.fanout ** lvl
        levels.append(gather_fill(keys, src, sent))
    return tuple(levels)


def _spread(cfg: PIConfig, sk: torch.Tensor, sv: torch.Tensor,
            n_keep: torch.Tensor):
    """Distribute the first ``n_keep`` sorted keys evenly over the segments.

    Every segment receives floor(n_keep/S) keys and the first
    ``n_keep mod S`` segments take one extra, so empty segments (if any)
    sit at the global tail (invariant L4).  Slots past ``n_keep`` become
    KSENT slack.  Returns the (C,) keys and vals arrays.
    """
    W, S, C = cfg.seg_width_eff, cfg.num_segments, cfg.capacity
    dev = sk.device
    sent = sentinel_for(sk.dtype)
    n_keep = n_keep.to(_I32)
    base = n_keep // S
    extra = n_keep % S
    i = torch.arange(C, dtype=_I32, device=dev)
    cut = extra * (base + 1)          # keys before `cut` land base+1 per seg
    big = (base + 1).clamp_min(1)
    sml = base.clamp_min(1)
    head = i < cut
    seg = torch.where(head, i // big, extra + (i - cut) // sml)
    off = torch.where(head, i % big, (i - cut) % sml)
    tgt = torch.where(i < n_keep, seg * W + off, C)  # C => dropped
    src_k = gather_fill(sk, i, sent)
    src_v = gather_fill(sv, i, 0)
    keys2 = _set_drop(torch.full((C,), sent, dtype=sk.dtype, device=dev),
                      tgt, src_k)
    vals2 = _set_drop(torch.zeros((C,), dtype=_I32, device=dev), tgt, src_v)
    return keys2, vals2


def _fresh_pending(cfg: PIConfig, kdt, device):
    PC = cfg.pending_capacity
    return dict(
        pkeys=torch.full((PC,), sentinel_for(kdt), dtype=kdt, device=device),
        pvals=torch.zeros((PC,), dtype=_I32, device=device),
        ptomb=torch.zeros((PC,), dtype=torch.bool, device=device),
        pn=_scalar(0, _I32, device),
        n_updates=_scalar(0, _I32, device))


def build(cfg: PIConfig, keys, vals, device=None) -> PIIndex:
    """Build a PI shard from (not necessarily sorted) unique keys.

    ``keys``/``vals`` may be numpy arrays or tensors; the index lives on
    ``device`` (default: the card).
    """
    dev = _device(device)
    kdt = torch_dtype(cfg.key_dtype)
    keys = torch.as_tensor(keys).to(device=dev, dtype=kdt)
    vals = torch.as_tensor(vals).to(device=dev, dtype=_I32)
    n = keys.shape[0]
    if n > cfg.capacity:
        raise ValueError(f"{n} keys > capacity {cfg.capacity}")
    order = torch.argsort(keys, stable=True)
    keys_s, vals_s = _spread(cfg, keys[order], vals[order],
                             _scalar(n, _I32, dev))
    return PIIndex(
        keys=keys_s, vals=vals_s,
        tomb=torch.zeros((cfg.capacity,), dtype=torch.bool, device=dev),
        n=_scalar(n, _I32, dev),
        levels=_build_levels(cfg, keys_s),
        overflow=_scalar(False, torch.bool, dev), config=cfg,
        **_fresh_pending(cfg, kdt, dev))


def empty(cfg: PIConfig, device=None) -> PIIndex:
    kdt = torch_dtype(cfg.key_dtype)
    return build(cfg, torch.zeros((0,), dtype=kdt),
                 torch.zeros((0,), dtype=_I32), device=device)


def from_numpy_leaves(cfg: PIConfig, leaves: Sequence, device=None) -> PIIndex:
    """A ``PIIndex`` from the JAX package's leaves as numpy arrays, in the
    ``tree_flatten`` order with ``levels`` a tuple; on ``device``
    (default: the card).  The way state crosses from one package to the
    other."""
    dev = _device(device)
    keys, vals, tomb, n, levels, pkeys, pvals, ptomb, pn, n_upd, ovf = leaves

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return PIIndex(
        keys=t(keys), vals=t(vals), tomb=t(tomb), n=t(n),
        levels=tuple(t(lv) for lv in levels),
        pkeys=t(pkeys), pvals=t(pvals), ptomb=t(ptomb), pn=t(pn),
        n_updates=t(n_upd), overflow=t(ovf), config=cfg)


def to_numpy_leaves(index: PIIndex) -> list:
    """The index's leaves as numpy arrays, in the JAX ``tree_flatten``
    order with ``levels`` a tuple (the inverse of ``from_numpy_leaves``)."""
    def a(x):
        return x.detach().cpu().numpy()

    return [tuple(a(lv) for lv in leaf) if isinstance(leaf, tuple) else a(leaf)
            for leaf in index.leaves()]


def flat_leaves(index: PIIndex) -> list:
    """The state tensors in the order ``jax.tree_util.tree_flatten`` gives
    the JAX ``PIIndex``: ``levels`` expanded in place, 10 + H leaves.  The
    order of a snapshot's ``leaf_0 .. leaf_{9+H}``."""
    return [index.keys, index.vals, index.tomb, index.n, *index.levels,
            index.pkeys, index.pvals, index.ptomb, index.pn, index.n_updates,
            index.overflow]


def from_flat_leaves(cfg: PIConfig, leaves: Sequence) -> PIIndex:
    """A ``PIIndex`` of ``cfg`` from tensors in the ``flat_leaves`` order
    (the inverse: regroups the ``H = cfg.num_levels`` level tensors)."""
    H = cfg.num_levels
    if len(leaves) != 10 + H:
        raise ValueError(f"{len(leaves)} leaves; a PIIndex with {H} levels "
                         f"has {10 + H}")
    keys, vals, tomb, n = leaves[:4]
    pkeys, pvals, ptomb, pn, n_upd, ovf = leaves[4 + H:]
    return PIIndex(keys=keys, vals=vals, tomb=tomb, n=n,
                   levels=tuple(leaves[4:4 + H]), pkeys=pkeys, pvals=pvals,
                   ptomb=ptomb, pn=pn, n_updates=n_upd, overflow=ovf,
                   config=cfg)


def leaf_spec(cfg: PIConfig) -> PIIndex:
    """A ``PIIndex`` of ``cfg``'s geometry on the ``meta`` device: every
    leaf's shape and dtype, no storage.  What a snapshot is restored into
    when no index exists yet (``pipeline.recovery.recover``)."""
    kdt = torch_dtype(cfg.key_dtype)
    C, PC = cfg.capacity, cfg.pending_capacity

    def m(n, dtype):
        return torch.empty((n,) if n is not None else (), dtype=dtype,
                           device="meta")

    return PIIndex(
        keys=m(C, kdt), vals=m(C, _I32), tomb=m(C, torch.bool),
        n=m(None, _I32),
        levels=tuple(m(cfg.level_size(lvl), kdt)
                     for lvl in range(1, cfg.num_levels + 1)),
        pkeys=m(PC, kdt), pvals=m(PC, _I32), ptomb=m(PC, torch.bool),
        pn=m(None, _I32), n_updates=m(None, _I32),
        overflow=m(None, torch.bool), config=cfg)


# ---------------------------------------------------------------------------
# traversal (the paper's Alg. 2 — index-layer BFS descent, via the engine)
# ---------------------------------------------------------------------------

def with_backend(index: PIIndex, backend: str, tile_q: int | None = None
                 ) -> PIIndex:
    """Same index state, different search backend (zero-copy rewrap)."""
    cfg = dataclasses.replace(
        index.config, backend=backend,
        tile_q=index.config.tile_q if tile_q is None else tile_q)
    return dataclasses.replace(index, config=cfg)


def traverse(index: PIIndex, q: torch.Tensor) -> torch.Tensor:
    """Floor positions: the slot whose key is the largest key <= q, or -1.

    Positions are gapped *slot* indices: monotone in the query key, but
    not consecutive across segment slack.
    """
    return get_engine(index.config).floor(index, q)


def _probe(index: PIIndex, q: torch.Tensor):
    """Engine probe + the liveness gathers the engine leaves to us.

    Returns (pos, main_match, main_live, main_val, ppos, p_match, p_live):
    the per-query pre-batch view of both layers, identical across backends.
    """
    pr = get_engine(index.config).probe(index, q)
    pos_c = pr.pos.clamp_min(0).long()
    ppos = pr.ppos.long()
    main_live = pr.main_match & ~index.tomb[pos_c]
    main_val = index.vals[pos_c]
    p_match = pr.p_hit & (pr.ppos < index.pn)
    p_live = p_match & ~index.ptomb[ppos]
    return pr.pos, pr.main_match, main_live, main_val, pr.ppos, p_match, \
        p_live


def lookup(index: PIIndex, q: torch.Tensor):
    """Batched point lookup → (found, val).  found=False is the paper's null."""
    _, _, main_live, main_val, ppos, _, p_live = _probe(
        index, q.to(index.keys.dtype))
    p_val = index.pvals[ppos.long()]
    found = main_live | p_live
    val = torch.where(p_live, p_val, main_val)
    return found, torch.where(found, val, 0)


# ---------------------------------------------------------------------------
# batch execution (Alg. 1 = partition→traverse→redistribute→execute)
# ---------------------------------------------------------------------------

# Bumped once per ``execute_impl`` on the ``cuda`` backend: the window's
# one pass through the kernels (one ``pi_probe``, one ``bitonic_sort``
# call).  Where the JAX package expects one trace of ``execute_impl`` a
# serving run, the port expects one of these a window; suites and the
# smoke run assert it through the guard's canonical message
# (analysis/runtime.py; deltas via execute_launch_count()).
_LAUNCHES = launch_guard("core.execute")


def execute_launch_count() -> int:
    """Executes run through the kernels so far: the counterpart of the
    JAX package's ``execute_trace_count``, one a window, not one a run."""
    return _LAUNCHES.count()


def execute_impl(index: PIIndex, ops: torch.Tensor, qkeys: torch.Tensor,
                 qvals: torch.Tensor):
    """Execute one query batch; returns (new_index, (found, vals)).

    Semantics == core.ref.RefIndex.execute: queries sorted by key (stable on
    arrival), each query sees earlier-arriving writes to its key segment.
    Every storage slot is written by exactly one scatter lane (the segment
    tail) — the paper's "each modified node is owned by exactly one
    thread" invariant.
    """
    cfg = index.config
    dev = index.device
    B = ops.shape[0]
    kdt = index.keys.dtype
    sent = sentinel_for(kdt)
    ops = torch.as_tensor(ops).to(device=dev, dtype=_I32)
    qkeys = torch.as_tensor(qkeys).to(device=dev, dtype=kdt)
    qvals = torch.as_tensor(qvals).to(device=dev, dtype=_I32)

    engine = get_engine(cfg)
    if engine.backend == "cuda":
        _LAUNCHES.bump()
    perm, s_ops, s_keys, s_vals = engine.sort_queries(ops, qkeys, qvals)
    newseg = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                        s_keys[1:] != s_keys[:-1]])
    is_write = s_ops != SEARCH
    is_del = s_ops == DELETE
    (inc_has, inc_val, inc_tomb), (exc_has, exc_val, exc_tomb) = (
        seg_last_write_scan(newseg, is_write, s_vals, is_del))

    # --- store state per query (pre-batch view, one fused engine probe) ---
    pos, main_match, main_live, main_val, ppos, p_match, p_live = _probe(
        index, s_keys)
    pos_c = pos.clamp_min(0)
    p_val = index.pvals[ppos.long()]
    store_found = main_live | p_live
    store_val = torch.where(p_live, p_val, main_val)

    # --- per-query results (visibility: exclusive scan > store) -----------
    vis_found = torch.where(exc_has, ~exc_tomb, store_found)
    vis_val = torch.where(exc_has, exc_val, store_val)
    is_search = s_ops == SEARCH
    r_found = torch.where(is_search, vis_found, is_del & vis_found)
    r_val = torch.where(is_search, torch.where(vis_found, vis_val, 0),
                        (is_del & vis_found).to(_I32))

    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(B, device=dev)
    results = (r_found[inv], r_val[inv])

    # --- net effects: one writer per key segment (segment tails) ----------
    seg_end = torch.cat([newseg[1:],
                         torch.ones((1,), dtype=torch.bool, device=dev)])
    apply_w = seg_end & inc_has
    # 1) key already in main storage → in-place update (Alg. 4 lines 11-15)
    upd_main = apply_w & main_match
    tgt = torch.where(upd_main, pos_c, cfg.capacity)  # OOB ⇒ dropped
    vals2 = _set_drop(index.vals, tgt,
                      torch.where(inc_tomb, main_val, inc_val))
    tomb2 = _set_drop(index.tomb, tgt, inc_tomb)
    # 2) key in pending buffer → in-place update there
    upd_pend = apply_w & ~main_match & p_match
    ptgt = torch.where(upd_pend, ppos, cfg.pending_capacity)
    pvals2 = _set_drop(index.pvals, ptgt,
                       torch.where(inc_tomb, p_val, inc_val))
    ptomb2 = _set_drop(index.ptomb, ptgt, inc_tomb)
    # 3) brand-new key, net insert → append to pending (sorted merge)
    new_ins = apply_w & ~main_match & ~p_match & ~inc_tomb
    addk = torch.where(new_ins, s_keys, sent)
    addv = torch.where(new_ins, inc_val, 0)
    PC = cfg.pending_capacity
    # hide slots beyond pn so stale tails don't resurrect
    pidx = torch.arange(PC, device=dev)
    mk = torch.cat([torch.where(pidx < index.pn, index.pkeys, sent), addk])
    mv = torch.cat([pvals2, addv])
    mt = torch.cat([ptomb2, torch.zeros((B,), dtype=torch.bool, device=dev)])
    order = torch.argsort(mk, stable=True)
    mk, mv, mt = mk[order], mv[order], mt[order]
    pn_new = index.pn + new_ins.sum(dtype=_I32)
    pn2 = pn_new.clamp_max(PC)
    overflow2 = index.overflow | (pn_new > PC)

    n_upd = index.n_updates + apply_w.sum(dtype=_I32)
    new_index = PIIndex(
        keys=index.keys, vals=vals2, tomb=tomb2, n=index.n,
        levels=index.levels,
        pkeys=mk[:PC], pvals=mv[:PC], ptomb=mt[:PC], pn=pn2,
        n_updates=n_upd, overflow=overflow2, config=cfg)
    return new_index, results


# PyTorch runs eagerly: there is no program to compile or donate into.
execute = execute_impl


def needs_rebuild(index: PIIndex) -> torch.Tensor:
    """Paper §4.3.5: rebuild after a threshold (15% of N) of updates.

    Exact integer arithmetic: ``rebuild_frac`` is frozen to a /1024
    rational and ``ceil(n * num / 1024)`` is computed with a split
    multiply, so it neither loses precision in float32 (n > 2**24) nor
    overflows int32.
    """
    num = int(round(index.config.rebuild_frac * 1024))
    n = index.n.to(_I32)
    q = torch.div(n, 1024, rounding_mode="floor")
    r = torch.remainder(n, 1024)
    thresh = (q * num + (r * num + 1023) // 1024).clamp_min(1)
    near_full = index.pn > (index.config.pending_capacity * 3) // 4
    return (index.n_updates >= thresh) | near_full | index.overflow


def _route_pending(index: PIIndex):
    """Route live pending keys to their destination segments.

    A segment is *dirty* iff at least one live pending key lands in its
    range (``searchsorted`` on the segment fences ``keys[::W]``).

    Returns ``(p_live, order, n_dirty, dirty, npend)``:
      p_live : (PC,) live pending mask
      order  : (PC,) slot of the (j+1)-th live pending entry (PC past the
               live count)
      n_dirty: ()   number of distinct dirty segments
      dirty  : (D,) ascending distinct dirty segment ids, padded with S
      npend  : (D,) live pending keys routed to each dirty segment
    """
    cfg = index.config
    dev = index.device
    W, S = cfg.seg_width_eff, cfg.num_segments
    D = min(cfg.max_dirty, cfg.pending_capacity)
    PC = cfg.pending_capacity
    pidx = torch.arange(PC, dtype=_I32, device=dev)
    p_live = (pidx < index.pn) & ~index.ptomb
    fences = index.keys[::W].contiguous()      # (S,) first key per segment
    dest = torch.searchsorted(fences, index.pkeys, right=True,
                              out_int32=True) - 1
    dest = torch.where(p_live, dest.clamp(0, S - 1), S)
    c_live = torch.cumsum(p_live.to(_I32), 0, dtype=_I32)
    order = torch.searchsorted(c_live, pidx + 1, out_int32=True)
    d_live = gather_fill(dest, order, S)                       # non-decr.
    first = (d_live < S) & torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=dev),
         d_live[1:] != d_live[:-1]])
    c_first = torch.cumsum(first.to(_I32), 0, dtype=_I32)
    n_dirty = c_first[-1]
    q = torch.searchsorted(
        c_first, torch.arange(1, D + 1, dtype=_I32, device=dev),
        out_int32=True)
    dirty = gather_fill(d_live, q, S)
    npend = torch.searchsorted(d_live, dirty, right=True, out_int32=True) - \
        torch.searchsorted(d_live, dirty, out_int32=True)
    npend = torch.where(dirty < S, npend, 0)
    return p_live, order, n_dirty, dirty, npend


def incremental_fits(index: PIIndex) -> torch.Tensor:
    """True iff the incremental merge can absorb the pending buffer: the
    dirty set fits the ``max_dirty`` gather width and every dirty
    segment's merged run (live keys + routed pending keys) fits its ``W``
    slots."""
    cfg = index.config
    W, S = cfg.seg_width_eff, cfg.num_segments
    sent = sentinel_for(index.keys.dtype)
    _, _, n_dirty, dirty, npend = _route_pending(index)
    D = dirty.shape[0]
    dk = gather_fill(index.keys.reshape(S, W), dirty, sent)
    dt = gather_fill(index.tomb.reshape(S, W), dirty, False)
    cnt = ((dk != sent) & ~dt).sum(1, dtype=_I32)
    return (n_dirty <= D) & (cnt + npend <= W).all()


def _rebuild_incremental(index: PIIndex) -> PIIndex:
    """Churn-proportional rebuild: merge pending keys into dirty segments.

    Cost scales with the dirty set (a (D, W) gather + one batched
    fixed-width key sort + rank lookups of the values + scatter-back), not
    with capacity.  Clean segments and the index-layer entries above them
    are untouched; tombstones are compacted inside dirty segments only.
    Only callable when ``incremental_fits`` holds.
    """
    cfg = index.config
    dev = index.device
    W, S, C = cfg.seg_width_eff, cfg.num_segments, cfg.capacity
    PC = cfg.pending_capacity
    kdt = index.keys.dtype
    sent = sentinel_for(kdt)
    p_live, order, _, dirty, npend = _route_pending(index)
    D = dirty.shape[0]
    kseg = index.keys.reshape(S, W)
    vseg = index.vals.reshape(S, W)
    tseg = index.tomb.reshape(S, W)
    dk = gather_fill(kseg, dirty, sent)
    dv = gather_fill(vseg, dirty, 0)
    dt = gather_fill(tseg, dirty, False)
    n_tomb = dt.sum(dtype=_I32)
    blank = torch.where(dt, sent, dk)     # drop tombstones from the merge
    # each dirty row's routed pending run: live pending is sorted by key,
    # hence contiguous per destination; row d spans live slots
    # [start_d, start_d + npend_d)
    start = torch.cat([torch.zeros((1,), dtype=_I32, device=dev),
                       torch.cumsum(npend, 0, dtype=_I32)[:-1]])
    col = torch.arange(W, dtype=_I32, device=dev)
    valid = col[None, :] < npend[:, None]
    slot = torch.where(valid, start[:, None] + col[None, :], PC)
    src = gather_fill(order, slot.reshape(-1), PC)
    pk = torch.where(valid, gather_fill(index.pkeys, src, sent).reshape(D, W),
                     sent)
    pv = torch.where(valid, gather_fill(index.pvals, src, 0).reshape(D, W), 0)
    # merged keys: `incremental_fits` guarantees <= W survivors per row,
    # so the dropped tail is all-sentinel
    mk = torch.sort(torch.cat([blank, pk], 1), 1).values[:, :W].contiguous()
    # values by rank lookup into the two sorted sources
    i = torch.searchsorted(dk, mk).clamp(0, W - 1)
    from_run = torch.take_along_dim(dk, i, 1) == mk
    j = torch.searchsorted(pk, mk).clamp(0, W - 1)
    mv = torch.where(from_run, torch.take_along_dim(dv, i, 1),
                     torch.take_along_dim(pv, j, 1))
    mv = torch.where(mk != sent, mv, 0)
    keys2 = _set_drop(kseg, dirty, mk).reshape(C)
    vals2 = _set_drop(vseg, dirty, mv).reshape(C)
    tomb2 = _set_drop(tseg, dirty, False).reshape(C)
    n2 = (index.n - n_tomb + p_live.sum(dtype=_I32)).to(_I32)
    # regenerate index-layer entries above the touched segments only.
    # stride <= W: the W//stride entries inside each dirty segment.
    # stride >  W: at most one entry can read from a dirty segment (the
    # one at floor(s*W/stride)); rewriting it with the fresh storage value
    # is correct whether or not it actually moved.
    levels = []
    for lvl in range(1, cfg.num_levels + 1):
        stride = cfg.fanout ** lvl
        if stride <= W:
            per = W // stride
            p = (dirty[:, None].long() * per
                 + torch.arange(per, device=dev)[None, :]).reshape(-1)
        else:
            p = dirty.long() * W // stride
        ent = gather_fill(keys2, p * stride, sent)
        levels.append(_set_drop(index.levels[lvl - 1], p, ent))
    return PIIndex(
        keys=keys2, vals=vals2, tomb=tomb2, n=n2, levels=tuple(levels),
        overflow=_scalar(False, torch.bool, dev), config=cfg,
        **_fresh_pending(cfg, kdt, dev))


def _rebuild_repack(index: PIIndex) -> PIIndex:
    """Full repack (paper §4.1/§4.3.5, made a sort+spread).

    Compacts every tombstone, merges the pending buffer, re-spreads the
    slack evenly across all segments and regenerates every index level.
    If live keys exceed capacity the largest keys are dropped and the
    ``overflow`` flag is raised on the NEW state (observable data loss).
    """
    cfg = index.config
    dev = index.device
    kdt = index.keys.dtype
    sent = sentinel_for(kdt)
    C, PC = cfg.capacity, cfg.pending_capacity
    m_live = (index.keys != sent) & ~index.tomb
    pidx = torch.arange(PC, device=dev)
    p_live = (pidx < index.pn) & ~index.ptomb
    allk = torch.cat([torch.where(m_live, index.keys, sent),
                      torch.where(p_live, index.pkeys, sent)])
    allv = torch.cat([index.vals, index.pvals])
    order = torch.argsort(allk, stable=True)
    n_live = m_live.sum(dtype=_I32) + p_live.sum(dtype=_I32)
    over = n_live > C
    n2 = n_live.clamp_max(C)
    keys2, vals2 = _spread(cfg, allk[order], allv[order], n2)
    return PIIndex(
        keys=keys2, vals=vals2,
        tomb=torch.zeros((C,), dtype=torch.bool, device=dev), n=n2,
        levels=_build_levels(cfg, keys2), overflow=over, config=cfg,
        **_fresh_pending(cfg, kdt, dev))


def rebuild_tier(index: PIIndex):
    """Deferred rebuild, two-tier → (new_index, took_incremental).

    Takes the churn-proportional incremental merge when the dirty segment
    set is small and every merged run fits its segment; the full repack
    otherwise (slack exhausted, dirty set too wide, or pending overflow
    pinned the flag).  Both tiers leave the pending buffer empty and the
    update counter at zero, and preserve invariants L1-L5.  The tier is
    chosen on the host: one device-to-host sync.
    """
    incremental = bool(incremental_fits(index) & ~index.overflow)
    if incremental:
        return _rebuild_incremental(index), True
    return _rebuild_repack(index), False


def rebuild(index: PIIndex) -> PIIndex:
    """Deferred rebuild, two-tier (see ``rebuild_tier``)."""
    return rebuild_tier(index)[0]


def maybe_rebuild(index: PIIndex) -> PIIndex:
    """The rebuild 'daemon': rebuild iff the update threshold tripped
    (one host read of ``needs_rebuild``)."""
    return rebuild(index) if bool(needs_rebuild(index)) else index


# Sanctioned forced-repack entry (PI001).
repack = _rebuild_repack


# ---------------------------------------------------------------------------
# range queries (paper §3.2.5 / Fig. 14)
# ---------------------------------------------------------------------------

def range_agg(index: PIIndex, lo, hi, max_span: int = 1024):
    """Batched range query → (count, sum_of_vals) over keys in [lo, hi].

    Walks up to ``max_span`` *occupied* slots from the interception of
    ``lo`` (the paper's storage-layer scan), plus the live pending keys in
    range.  The walk advances through occupied ranks, so segment slack
    never spends the budget; tombstoned slots keep their key and rank,
    hence spend it, but are gated out of the aggregate.  Dispatches
    ``SearchEngine.range_agg``; ``lo``/``hi`` move to the index's device.
    """
    kdt = index.keys.dtype
    lo = torch.as_tensor(lo).to(device=index.device, dtype=kdt)
    hi = torch.as_tensor(hi).to(device=index.device, dtype=kdt)
    return get_engine(index.config).range_agg(index, lo, hi, max_span)


# convenience wrappers ------------------------------------------------------

def search_batch(index: PIIndex, keys: torch.Tensor):
    ops = torch.full(keys.shape, SEARCH, dtype=_I32, device=keys.device)
    vals = torch.zeros(keys.shape, dtype=_I32, device=keys.device)
    return execute(index, ops, keys, vals)


def insert_batch(index: PIIndex, keys: torch.Tensor, vals: torch.Tensor):
    ops = torch.full(keys.shape, INSERT, dtype=_I32, device=keys.device)
    return execute(index, ops, keys, vals)


def delete_batch(index: PIIndex, keys: torch.Tensor):
    ops = torch.full(keys.shape, DELETE, dtype=_I32, device=keys.device)
    vals = torch.zeros(keys.shape, dtype=_I32, device=keys.device)
    return execute(index, ops, keys, vals)


# ---------------------------------------------------------------------------
# host-side introspection (tests / benchmarks)
# ---------------------------------------------------------------------------

def live_items(index: PIIndex):
    """All live (key, val) pairs across both layers, sorted by key (numpy).

    The occupancy test is ``key != KSENT`` — never a dense ``[:n]`` prefix,
    which the gapped layout does not have.
    """
    sent = sentinel_for(index.keys.dtype)
    keys = index.keys.cpu().numpy()
    vals = index.vals.cpu().numpy()
    m = (keys != sent) & ~index.tomb.cpu().numpy()
    pn = int(index.pn)
    pk = index.pkeys[:pn].cpu().numpy()
    pv = index.pvals[:pn].cpu().numpy()
    pm = ~index.ptomb[:pn].cpu().numpy()
    k = np.concatenate([keys[m], pk[pm]])
    v = np.concatenate([vals[m], pv[pm]])
    order = np.argsort(k, kind="stable")
    return k[order], v[order]


def validate_layout(index: PIIndex) -> bool:
    """Assert the segmented-layout invariants L1-L5 plus bookkeeping.

    Host-side (copies the state to the host); raises AssertionError with
    the violated invariant, returns True otherwise.
    """
    cfg = index.config
    W, S = cfg.seg_width_eff, cfg.num_segments
    assert S * W == cfg.capacity, "geometry: S*W != C"
    sent = sentinel_for(index.keys.dtype)
    keys = index.keys.cpu().numpy()
    seg = keys.reshape(S, W)
    occ = seg != sent
    # L1: run prefix + slack tail (occupancy never rises within a row)
    assert not np.any(~occ[:, :-1] & occ[:, 1:]), "L1: gap inside a run"
    # L2: strictly increasing runs
    wide = seg.astype(np.float64 if seg.dtype.kind == "f" else np.int64)
    run_ok = np.diff(wide, axis=1) > 0
    assert np.all(run_ok | ~(occ[:, :-1] & occ[:, 1:])), "L2: run unsorted"
    # L3: runs ordered across segments; L4: empties only at the tail
    ne = np.flatnonzero(occ.any(axis=1))
    assert ne.size == 0 or ne[-1] == ne.size - 1, "L4: mid-array empty seg"
    rows = wide[ne]
    last_col = occ[ne].sum(axis=1) - 1
    lasts = rows[np.arange(ne.size), last_col]
    firsts = rows[:, 0]
    assert np.all(lasts[:-1] < firsts[1:]), "L3: segments out of order"
    # bookkeeping: n counts occupied slots; tombstones only on occupied
    assert int(index.n) == int(occ.sum()), "n != occupied slots"
    assert not np.any(index.tomb.cpu().numpy().reshape(S, W) & ~occ), \
        "tombstone on a slack slot"
    # index layer must equal a fresh bottom-up build over these keys
    for lvl, (got, want) in enumerate(
            zip(index.levels, _build_levels(cfg, index.keys)), 1):
        assert torch.equal(got, want), f"level {lvl} stale"
    # pending: sorted unique live prefix, sentinel tail
    pk = index.pkeys.cpu().numpy()
    pn = int(index.pn)
    assert np.all(pk[pn:] == sent), "pending tail not sentinel"
    assert np.all(np.diff(pk[:pn].astype(wide.dtype)) > 0), \
        "pending prefix unsorted"
    return True
