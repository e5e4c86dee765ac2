"""The plain reference: what every answer of a run must be.

Plain PyTorch over the benchmark's own inputs; it imports nothing of the
program.  Semantics, as the index states them:

* ops run in the order the clients issued them, cut into windows; a
  window is a contiguous run of that order;
* a point op (SEARCH, INSERT, DELETE) sees every write issued before it,
  in earlier windows and earlier in its own window: a SEARCH returns
  ``(found, value)`` of the key's last write, else of the loaded record,
  an INSERT (insert or update) returns ``(False, 0)``, a DELETE
  ``(found, found)``;
* a RANGE ``[lo, hi]`` returns the count and the int32-wrapped sum of the
  values of the live keys in range as of its window's start;
* the live set after the run is the loaded records with every write
  applied.

It works on sorted arrays: the loaded records sorted once with their value
prefix sums, and the run's writes sorted by (key, issue order), so that
each answer is a binary search and a range is the loaded part plus the
keys the run wrote inside it.  Nothing here is sized to the index's
capacity: what it holds grows with the records and with the run's ops.
"""
from __future__ import annotations

import torch

from pibench.ycsb import DELETE, INSERT, RANGE, SEARCH

_SHIFT = 32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 sums reduced modulo 2^32 into int32."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


class Reference:
    """The loaded records and the run's writes, ready to answer."""

    def __init__(self, base_keys: torch.Tensor, base_vals: torch.Tensor,
                 ops: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor):
        """``base_*``: the loaded records; ``ops/keys/vals``: every op the
        clients issued, in issue order (a RANGE's ``keys`` is its lower
        bound)."""
        bk, order = torch.sort(base_keys.long())
        self.bk = bk
        self.bv = base_vals.long()[order]
        zero = torch.zeros(1, dtype=torch.int64, device=bk.device)
        self.prefix = torch.cat([zero, torch.cumsum(self.bv, 0)])
        g = torch.arange(ops.shape[0], device=ops.device)
        is_w = (ops == INSERT) | (ops == DELETE)
        wk = keys[is_w].long()
        comp, order = torch.sort((wk << _SHIFT) | g[is_w])
        self.w_comp = comp
        self.w_key = wk[order]
        self.w_val = vals[is_w].long()[order]
        self.w_del = (ops[is_w] == DELETE)[order]
        self.w_keys = torch.unique_consecutive(self.w_key)

    def _base(self, k: torch.Tensor):
        """(in the loaded records, value) of keys ``k``."""
        i = torch.searchsorted(self.bk, k).clamp_max(self.bk.numel() - 1)
        hit = self.bk[i] == k
        return hit, torch.where(hit, self.bv[i], 0)

    def _as_of(self, k: torch.Tensor, before: torch.Tensor):
        """(live, value) of keys ``k`` after every write issued before
        op index ``before``."""
        live, val = self._base(k)
        if not self.w_comp.numel():
            return live, val
        i = torch.searchsorted(self.w_comp, (k << _SHIFT) | before) - 1
        ic = i.clamp_min(0)
        has = (i >= 0) & (self.w_key[ic] == k)
        live = torch.where(has, ~self.w_del[ic], live)
        return live, torch.where(live, torch.where(has, self.w_val[ic], val),
                                 0)

    def points(self, ops, keys, index):
        """(found, value) of point ops issued at ``index``."""
        live, val = self._as_of(keys.long(), index)
        found = torch.where(ops == SEARCH, live, (ops == DELETE) & live)
        value = torch.where(ops == SEARCH, val, (ops == DELETE) & live)
        return found, value.long()

    def ranges(self, lo, hi, start):
        """(count, int32 sum) of ranges ``[lo, hi]`` as of op index
        ``start``, their window's first op."""
        lo, hi = lo.long(), hi.long()
        a = torch.searchsorted(self.bk, lo)
        b = torch.searchsorted(self.bk, hi, right=True)
        cnt = b - a
        sm = self.prefix[b] - self.prefix[a]
        # the keys the run wrote inside each range: their state as of the
        # window's start replaces the loaded one
        wa = torch.searchsorted(self.w_keys, lo)
        n = torch.searchsorted(self.w_keys, hi, right=True) - wa
        rid = torch.repeat_interleave(torch.arange(lo.numel(),
                                                   device=lo.device), n)
        if rid.numel():
            first = torch.cumsum(n, 0) - n
            k = self.w_keys[wa[rid] + torch.arange(rid.numel(),
                                                   device=lo.device)
                            - first[rid]]
            live, val = self._as_of(k, start[rid])
            blive, bval = self._base(k)
            cnt = cnt.index_add(0, rid, live.long() - blive.long())
            sm = sm.index_add(0, rid, val - bval)
        return cnt, wrap_i32(sm).long()

    def live_set(self):
        """The live (keys, values) after every write, sorted by key."""
        last = torch.ones_like(self.w_key, dtype=torch.bool)
        last[:-1] = self.w_key[1:] != self.w_key[:-1]
        k, v, d = self.w_key[last], self.w_val[last], self.w_del[last]
        written = torch.zeros_like(self.bk, dtype=torch.bool)
        if k.numel():
            i = torch.searchsorted(k, self.bk).clamp_max(k.numel() - 1)
            written = k[i] == self.bk
        keys = torch.cat([self.bk[~written], k[~d]])
        vals = torch.cat([self.bv[~written], v[~d]])
        keys, order = torch.sort(keys)
        return keys, vals[order]


def expected(ref: Reference, ops, keys, keys2, window, block: int = 1 << 22):
    """The reference's two answer words for every op, in issue order: a
    point op's (found, value), a RANGE's (count, sum); ``window`` is each
    op's window number (non-decreasing).  In blocks of ``block`` ops."""
    n = ops.shape[0]
    dev = ops.device
    index = torch.arange(n, device=dev)
    wins, first = torch.unique_consecutive(window, return_counts=True)
    start_of = torch.cumsum(first, 0) - first
    start = start_of[torch.searchsorted(wins, window)]
    a1 = torch.zeros(n, dtype=torch.int64, device=dev)
    a2 = torch.zeros(n, dtype=torch.int64, device=dev)
    for s in range(0, n, block):
        sl = slice(s, min(n, s + block))
        o = ops[sl]
        is_r = o == RANGE
        f, v = ref.points(o, keys[sl], index[sl])
        c, m = ref.ranges(keys[sl][is_r], keys2[sl][is_r], start[sl][is_r])
        f, v = f.long(), v.clone()
        f[is_r], v[is_r] = c, m
        a1[sl], a2[sl] = f, v
    return a1, a2


def set_difference(k1, v1, k2, v2) -> int:
    """How far two sorted (key, value) sets lie apart: 0 iff equal."""
    n = min(k1.numel(), k2.numel())
    diff = (k1[:n].long() != k2[:n].long()) | (v1[:n].long() != v2[:n].long())
    return abs(k1.numel() - k2.numel()) + int(diff.sum())
