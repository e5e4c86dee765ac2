"""Data: the stateless synthetic LM stream and YCSB-style index workloads.

Counterpart of ``repro.data``.  Everything is a function of (seed, step,
host), so a restarted or resumed run needs no pipeline state in its
checkpoints.

* ``lm_batch`` draws on a CPU ``torch.Generator`` seeded from (seed,
  step, host) and copies the batch to the target device, so one seed
  gives the same batch on every device: the JAX package's formulas
  (zipf-like ranks ``u ** (-1/1.1)`` clipped to ``vocab - 1``, tokens and
  labels shifted by one), other numbers than ``jax.random`` gives.
* The YCSB half is numpy and a copy of the JAX package's: the same seed
  gives the same keys, values and batches in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.index import _device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32_000
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    input_mode: str = "tokens"   # tokens | embeddings
    d_model: int = 0             # for embeddings mode


def lm_batch(cfg: DataConfig, step: int, host: int = 0, n_hosts: int = 1,
             device=None) -> Dict[str, torch.Tensor]:
    """Deterministic batch for (step, host) on ``device`` (default: the
    card).  Zipf-ish token marginals so losses behave like text rather
    than uniform noise; int32 tokens and labels."""
    device = _device(device)
    b = cfg.global_batch // n_hosts
    seed = np.random.SeedSequence([cfg.seed, step, host]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(seed))   # on the CPU
    # zipf via exponentiated uniform: rank ~ u^(-1/s), s≈1.1
    u = torch.rand((b, cfg.seq_len + 1), generator=gen)
    u = 1e-6 + (1 - 1e-6) * u
    ranks = torch.clamp((u ** (-1.0 / 1.1)).to(torch.int32), 0, cfg.vocab - 1)
    ranks = ranks.to(device)
    tokens = ranks[:, :-1]
    labels = ranks[:, 1:]
    if cfg.input_mode == "embeddings":
        emb = torch.randn((b, cfg.seq_len, cfg.d_model), generator=gen)
        return {"embeds": emb.to(device), "labels": labels}
    return {"tokens": tokens, "labels": labels}


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


def range_batch(cfg: YCSBConfig, keys: np.ndarray, step: int,
                granularity: int):
    """Range-query batch: [lo, hi] spans covering ~granularity keys."""
    rng = np.random.default_rng((cfg.seed, step, granularity))
    span = cfg.key_space * granularity // len(keys)
    lo = rng.integers(0, cfg.key_space - span, cfg.batch).astype(np.int32)
    hi = (lo + span).astype(np.int32)
    return lo, hi
