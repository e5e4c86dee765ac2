"""Pure-Python oracle for PI index semantics.

The paper's index is, semantically, a sorted map with batch-serializable
execution: a query batch is sorted by key (stable on arrival order), and each
query observes the effects of every earlier-arriving write *to the same key*
within the batch (per-thread sequential execution in Alg. 4), as well as all
writes from previous batches.  Deletes are tombstones (F_del); range queries
scan the merged view.

This module implements those semantics with a plain dict so that the
PyTorch implementation (core/index.py) and the CUDA kernels can be tested
against it.  It is a copy of ``repro.core.ref``: the port imports nothing
of the JAX package.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Optional

SEARCH, INSERT, DELETE = 0, 1, 2


@dataclass
class RefIndex:
    """Sorted-map oracle. Values are ints; NULL result is None."""

    data: dict = field(default_factory=dict)

    @classmethod
    def build(cls, keys, values) -> "RefIndex":
        d = {}
        for k, v in zip(keys, values):
            d[int(k)] = int(v)
        return cls(d)

    def execute(self, ops, keys, vals):
        """Execute one batch; returns list of per-query results (None = null).

        Queries are processed in sorted-by-key order with arrival order
        breaking ties (== the paper's sorted query set + per-thread
        sequential execution).  Inserts/deletes are visible to later queries
        in the same batch (same key segment), matching Alg. 4.
        """
        order = sorted(range(len(ops)), key=lambda i: (int(keys[i]), i))
        results: list = [None] * len(ops)
        for i in order:
            op, k = int(ops[i]), int(keys[i])
            if op == SEARCH:
                results[i] = self.data.get(k)
            elif op == INSERT:
                self.data[k] = int(vals[i])
            elif op == DELETE:
                results[i] = 1 if k in self.data else None
                self.data.pop(k, None)
        return results

    def search(self, key) -> Optional[int]:
        return self.data.get(int(key))

    def floor(self, key) -> Optional[int]:
        """Largest stored key <= key (the paper's 'interception' target)."""
        ks = sorted(self.data)
        i = bisect.bisect_right(ks, int(key))
        return ks[i - 1] if i else None

    def range(self, lo, hi):
        """All (k, v) with lo <= k <= hi in key order."""
        return [(k, self.data[k]) for k in sorted(self.data) if int(lo) <= k <= int(hi)]

    def __len__(self):
        return len(self.data)
