"""Quickstart: build a PI index, run mixed batches, range queries, rebuild.

The port's counterpart of ``examples/quickstart.py``: the same data from
the same numpy seed, the same calls and printed lines, on the card
(``pi_probe``, ``bitonic_sort`` and ``pi_range`` run there) or, with
``--device cpu``, on their plain versions.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (INSERT, PIConfig, build, execute, lookup,
                              maybe_rebuild, needs_rebuild, range_agg)


def main(argv=None):
    """Runs the example; returns its results (what it prints)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a).to(dev)

    # --- build from an initial dataset (paper §3.1: bottom-up O(n)) ------
    cfg = PIConfig(capacity=1 << 16, pending_capacity=1 << 12, fanout=8)
    keys = rng.choice(1 << 20, size=20_000, replace=False).astype(np.int32)
    vals = np.arange(20_000, dtype=np.int32)
    index = build(cfg, keys, vals, device=dev)
    print(f"built index: {int(index.n)} keys, "
          f"{cfg.num_levels} index-layer levels, fanout {cfg.fanout}")

    # --- one sorted mixed batch (paper Alg. 1: the unit of work) ---------
    B = 1024
    ops = rng.integers(0, 3, B).astype(np.int32)     # SEARCH/INSERT/DELETE
    qkeys = rng.choice(keys, B).astype(np.int32)
    qvals = rng.integers(0, 1 << 20, B).astype(np.int32)
    index, (found, val) = execute(index, t(ops), t(qkeys), t(qvals))
    n_hit = int(found.sum())
    pn = index.pn
    print(f"batch of {B}: {n_hit} non-null results, "
          f"pending inserts={int(pn)}")

    # --- point lookups ----------------------------------------------------
    f, v = lookup(index, t(keys[:4]))
    looked = [int(x) if ok else None for ok, x in zip(f.tolist(), v.tolist())]
    print("lookup", keys[:4].tolist(), "->", looked)

    # --- range aggregate (paper §3.2.5) -----------------------------------
    lo = t(np.array([0, 1 << 18], np.int32))
    hi = t(np.array([1 << 18, 1 << 19], np.int32))
    cnt, sm = range_agg(index, lo, hi, 4096)
    print("range counts:", cnt.tolist())

    # --- deferred rebuild (paper §4.3.5 daemon) ----------------------------
    newk = (rng.choice(1 << 20, size=4000, replace=False) + (1 << 21)) \
        .astype(np.int32)
    index, _ = execute(index, t(np.full((4000,), INSERT, np.int32)), t(newk),
                       t(np.arange(4000, dtype=np.int32)))
    due = bool(needs_rebuild(index))
    print("needs_rebuild:", due)
    index = maybe_rebuild(index)
    print(f"after rebuild: n={int(index.n)}, pending={int(index.pn)}")
    return {"hits": n_hit, "pending": int(pn), "lookup": looked,
            "range_counts": cnt.tolist(), "range_sums": sm.tolist(),
            "needs_rebuild": due, "n": int(index.n),
            "pending_after": int(index.pn)}


if __name__ == "__main__":
    main()
