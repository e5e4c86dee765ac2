"""Public wrappers of the kernels, as ``repro.kernels.ops`` has them.

Each wrapper runs the kernel on a CUDA tensor and its plain version on a
CPU tensor (the port's counterpart of the JAX package's interpret mode).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bitonic_sort import bitonic_sort
from repro_torch.kernels.pi_search import pi_search


def pi_search_op(storage: torch.Tensor, queries: torch.Tensor,
                 fanout: int = 8, tile_q: int = 256) -> torch.Tensor:
    """Floor positions of ``queries`` in the sorted padded ``storage``."""
    return pi_search(storage, queries, fanout=fanout, tile_q=tile_q)


def bitonic_sort_op(keys: torch.Tensor, vals: torch.Tensor):
    """Ascending (key, val) lexicographic sort of a power-of-two batch."""
    return bitonic_sort(keys, vals)


def sort_queries_kernel(ops: torch.Tensor, keys: torch.Tensor,
                        vals: torch.Tensor):
    """Paper Def. 3: sort a query batch by key, stable on arrival order.

    Packs the arrival index into the tie-break lane so the bitonic network
    reproduces a stable sort, then applies the permutation (int32, as in
    the JAX package) to the full (op, key, val) triplet.
    """
    arrival = torch.arange(keys.shape[0], dtype=torch.int32,
                           device=keys.device)
    _, perm = bitonic_sort_op(keys, arrival)
    idx = perm.long()
    return perm, ops[idx], keys[idx], vals[idx]
