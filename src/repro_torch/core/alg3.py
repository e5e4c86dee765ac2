"""Reference simulation of the paper's thread protocol (Algorithms 1-4).

This is a *fidelity artifact*, not the production path: it executes a query
batch exactly the way the paper's threads do — partition the sorted batch
into T contiguous chunks (Alg. 1 line 3), find interceptions (Alg. 2),
hand off boundary queries whose interception collides with the next
thread's first interception (Alg. 3), then execute per-thread sequentially
(Alg. 4).

Tests assert that (a) after redistribution the per-thread interception sets
are disjoint — the paper's latch-freedom invariant — and (b) the final
state and results equal the production bulk execution in ``core.index``,
i.e. the functional adaptation preserves the protocol's semantics.

A copy of ``repro.core.alg3`` (the port imports nothing of the JAX
package): pure Python, no tensors.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np

from repro_torch.core.batch import SEARCH, INSERT, DELETE


@dataclass
class Alg3Result:
    results: list           # per original query (None = null)
    state: dict             # final key → value
    ownership: list         # per thread: set of interception keys owned
    handoffs: int           # queries moved by Alg. 3


def run_threads(init: dict, ops, keys, vals, n_threads: int) -> Alg3Result:
    """Execute one batch with the paper's per-thread protocol."""
    B = len(ops)
    order = sorted(range(B), key=lambda i: (int(keys[i]), i))  # Def. 3
    chunks = np.array_split(np.array(order), n_threads)        # Alg. 1 l.3

    store_keys = sorted(init)                                  # storage layer

    def interception(k):                                       # Alg. 2 / Def. 4
        i = bisect.bisect_right(store_keys, int(k))
        return store_keys[i - 1] if i else None

    # per-thread interception sets
    batches = [list(c) for c in chunks]
    icepts = [[interception(keys[i]) for i in b] for b in batches]

    # Alg. 3: scan backwards; hand queries whose interception equals the
    # next thread's *first* interception to the next thread (in thread-id
    # order, so a run spanning >2 threads cascades correctly).
    handoffs = 0
    for t in range(n_threads - 1):
        nxt = t + 1
        first_next = icepts[nxt][0] if icepts[nxt] else None
        if first_next is None:
            continue
        moved_q, moved_i = [], []
        while icepts[t] and icepts[t][-1] == first_next:
            moved_q.append(batches[t].pop())
            moved_i.append(icepts[t].pop())
            handoffs += 1
        batches[nxt][:0] = reversed(moved_q)
        icepts[nxt][:0] = reversed(moved_i)

    ownership = [set(i for i in ic if i is not None) for ic in icepts]

    # Alg. 4: per-thread sequential execution on the shared state; the
    # protocol guarantees threads touch disjoint nodes, so sequential
    # thread order == any interleaving.
    state = dict(init)
    results = [None] * B
    for b in batches:
        for i in b:
            op, k = int(ops[i]), int(keys[i])
            if op == SEARCH:
                results[i] = state.get(k)
            elif op == INSERT:
                state[k] = int(vals[i])
            else:
                results[i] = 1 if k in state else None
                state.pop(k, None)
    return Alg3Result(results, state, ownership, handoffs)
