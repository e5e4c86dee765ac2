"""YCSB-style index workloads (paper §6), numpy only.

A copy of the YCSB half of ``repro.data``: the same seed gives the same
keys, values and batches in both packages.  The LM stream waits for the
port of the LM substrate.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class YCSBConfig:
    n_keys: int = 1 << 20        # dataset size (paper: 2M..256M)
    key_space: int = 1 << 30
    batch: int = 8192            # paper default batch size
    write_ratio: float = 0.0     # fraction of inserts (paper: 0..100%)
    theta: float = 0.0           # zipfian parameter (paper: 0, 0.5, 0.9)
    seed: int = 0


def ycsb_dataset(cfg: YCSBConfig):
    rng = np.random.default_rng(cfg.seed)
    keys = rng.choice(cfg.key_space, size=cfg.n_keys, replace=False) \
        .astype(np.int32)
    vals = rng.integers(0, 1 << 30, cfg.n_keys).astype(np.int32)
    return keys, vals


def _zipf_ranks(rng, n, theta, n_items):
    """Zipfian ranks via inverse-CDF approximation (YCSB's generator)."""
    if theta <= 0.0:
        return rng.integers(0, n_items, n)
    u = rng.random(n)
    # approximate inverse of the zipf CDF with exponent theta
    ranks = np.floor(n_items * u ** (1.0 / (1.0 - theta))).astype(np.int64)
    return np.clip(ranks, 0, n_items - 1)


def ycsb_batch(cfg: YCSBConfig, keys: np.ndarray, step: int):
    """One query batch: ops/keys/vals arrays (sorted-key Zipf access)."""
    rng = np.random.default_rng((cfg.seed, step))
    ranks = _zipf_ranks(rng, cfg.batch, cfg.theta, len(keys))
    # map rank→key through a multiplicative hash so hot keys are spread
    # over the key space (YCSB scrambled zipfian)
    idx = (ranks * 2654435761 % len(keys)).astype(np.int64)
    qkeys = keys[idx]
    is_write = rng.random(cfg.batch) < cfg.write_ratio
    ops = np.where(is_write, 1, 0).astype(np.int32)   # INSERT else SEARCH
    # half of inserts target new keys (growth), half update existing
    new_key = is_write & (rng.random(cfg.batch) < 0.5)
    fresh = rng.integers(0, cfg.key_space, cfg.batch).astype(np.int32)
    qkeys = np.where(new_key, fresh, qkeys).astype(np.int32)
    vals = rng.integers(0, 1 << 30, cfg.batch).astype(np.int32)
    return ops, qkeys, vals
