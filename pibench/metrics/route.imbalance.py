"""Routing over shards: the largest over the mean count of real queries a
shard received in a window, from the window's keys and the index's fence
keys read after the run, averaged over the windows submitted in the
window."""
import numpy as np

from pibench import ycsb


def read(run):
    f = run.fences
    if f is None:
        return None
    shards = f.shape[0] - 1
    sent = np.iinfo(np.int32).max
    ratios = []
    for w, t in run.submitted:
        if not run.in_window(t):
            continue
        k = np.asarray(w.keys)[: w.occupancy]
        k = k[(np.asarray(w.ops)[: w.occupancy] != ycsb.RANGE) & (k != sent)]
        if k.size == 0:
            continue
        dest = np.clip(np.searchsorted(f[1:-1], k, side="right"), 0,
                       shards - 1)
        load = np.bincount(dest, minlength=shards)
        ratios.append(load.max() / load.mean())
    return float(np.mean(ratios)) if ratios else None
