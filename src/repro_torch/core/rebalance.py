"""Fence rebalancing — the analogue of self-adjusted threading (§4.3.3).

The paper reacts to skew by moving *threads* to hot NUMA nodes.  Shards on
a device cannot trade cores, so the index moves the *range boundaries*
(fence keys) instead: shards that absorb more queries shrink their key
range, shards that absorb fewer grow it.  The objective is identical —
equalize per-worker query load — the knob differs (documented as a changed
assumption in DESIGN.md §2).

Two estimators are provided:

* ``rebalance_from_load``: exponential-moving-average per-shard load →
  piecewise-linear re-interpolation of fences (cheap; runs every batch).
* ``rebalance_from_sample``: exact equi-depth fences from a key sample
  (used at rebuild time, mirroring the paper's daemon).

A copy of ``repro.core.rebalance``: numpy only, the same fences from the
same loads.
"""
from __future__ import annotations

import numpy as np


def rebalance_from_load(fences: np.ndarray, load: np.ndarray,
                        smoothing: float = 0.5,
                        key_lo=None, key_hi=None) -> np.ndarray:
    """New fences so predicted per-shard load is uniform.

    Treats each shard's load as uniformly spread over its key range and
    re-cuts the piecewise-linear CDF at equal quantiles.  ``smoothing``
    blends old and new fences (EMA) to avoid thrash on noisy batches.

    ``key_lo``/``key_hi`` bound the *real* key domain: the outer fences are
    dtype extremes (±∞ analogues) and must not anchor the interpolation —
    otherwise a hot first shard would smear the new fences across the
    unpopulated half of the int range.
    """
    orig = np.asarray(fences)
    fences = orig.astype(np.float64).copy()
    if key_lo is not None:
        fences[0] = float(key_lo)    # pilint: disable=PI004 — CDF estimate
    if key_hi is not None:
        fences[-1] = float(key_hi)   # pilint: disable=PI004 — CDF estimate
    load = np.maximum(np.asarray(load, dtype=np.float64), 1e-9)
    S = len(load)
    cdf = np.concatenate([[0.0], np.cumsum(load)])
    cdf /= cdf[-1]
    targets = np.arange(1, S) / S
    # interior fences: invert the piecewise-linear CDF over key space
    new_interior = np.interp(targets, cdf, fences)
    out = fences.copy()
    out[1:-1] = (1 - smoothing) * fences[1:-1] + smoothing * new_interior
    # keep fences strictly increasing
    for i in range(1, S):
        out[i] = max(out[i], out[i - 1] + 1)
    out[0], out[-1] = orig[0], orig[-1]  # outer fences stay at dtype extremes
    kdt = orig.dtype
    return out.astype(kdt) if np.issubdtype(kdt, np.integer) else out


def rebalance_from_sample(keys: np.ndarray, n_shards: int,
                          lo, hi) -> np.ndarray:
    """Equi-depth fences from a sorted key sample (rebuild-time exactness)."""
    keys = np.sort(np.asarray(keys))
    cuts = [keys[(len(keys) * s) // n_shards] for s in range(1, n_shards)]
    return np.array([lo, *cuts, hi])


def load_imbalance(load: np.ndarray) -> float:
    """max/mean load ratio — 1.0 is perfectly balanced."""
    load = np.asarray(load, dtype=np.float64)
    m = load.mean()
    return float(load.max() / m) if m > 0 else 1.0
