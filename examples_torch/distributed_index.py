"""Multi-shard PI index example: NUMA-style range partitioning over 8
shards, skewed workload, fence rebalancing (self-adjusted threading).

The port's counterpart of ``examples/distributed_index.py``, whose 8
forced host devices become 8 fence-routed shards in one process on one
card (``core/distributed.py``): each window's lanes are routed to their
shards, sorted (``bitonic_sort``) and probed (``pi_probe``) once a shard.

  PYTHONPATH=src python examples_torch/distributed_index.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import data as data_mod
from repro_torch.core import (PIConfig, build_sharded, collect_pairs,
                              load_imbalance, make_mesh,
                              make_sharded_executor, rebalance_from_load)


def main(argv=None):
    """Runs the example; returns the per-shard loads before and after."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keys", type=int, default=1 << 15)
    args = ap.parse_args(argv)
    S, N = 8, args.keys
    cfg = PIConfig(capacity=2 * N, pending_capacity=N // 8, fanout=8)
    ycfg = data_mod.YCSBConfig(n_keys=N, batch=4096, theta=0.9)  # skewed!
    keys, vals = data_mod.ycsb_dataset(ycfg)
    state = build_sharded(cfg, S, keys, vals, device=args.device)
    mesh = make_mesh((S,), ("data",), device=args.device)
    run, cap = make_sharded_executor(mesh, cfg, ycfg.batch // S,
                                     capacity_factor=8.0)

    shards, fences = state.shards, state.fences
    loads = np.zeros(S)
    for step in range(4):
        ops, k, v = (torch.as_tensor(a).to(args.device) for a in
                     data_mod.ycsb_batch(ycfg, keys, step))
        shards, f, vv, load, drop = run(shards, fences, ops, k, v)
        loads += load.cpu().numpy()
    print(f"zipf(0.9) load per shard: {loads.astype(int).tolist()}")
    print(f"imbalance before rebalance: {load_imbalance(loads):.2f}x")

    fences2 = rebalance_from_load(fences.cpu().numpy(), loads,
                                  smoothing=1.0, key_lo=int(keys.min()),
                                  key_hi=int(keys.max()))
    kk, vv2 = collect_pairs(dataclasses.replace(state, shards=shards))
    state2 = build_sharded(cfg, S, kk, vv2, fences=fences2,
                           device=args.device)
    shards2, fences2 = state2.shards, state2.fences
    loads2 = np.zeros(S)
    for step in range(4, 8):
        ops, k, v = (torch.as_tensor(a).to(args.device) for a in
                     data_mod.ycsb_batch(ycfg, keys, step))
        shards2, f, vv, load, drop = run(shards2, fences2, ops, k, v)
        loads2 += load.cpu().numpy()
    print(f"load after rebalance:       {loads2.astype(int).tolist()}")
    print(f"imbalance after rebalance:  {load_imbalance(loads2):.2f}x")
    return {"before": loads.tolist(), "after": loads2.tolist()}


if __name__ == "__main__":
    main()
