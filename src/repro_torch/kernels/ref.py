"""Plain oracles for the kernels, in stock PyTorch ops.

Counterpart of ``repro.kernels.ref``: each kernel has an exact reference
here, written independently of the kernel's own plain version; the tests
hold the kernels and their plain versions to these bit for bit.
"""
from __future__ import annotations

import torch


def pi_search_ref(storage: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Floor positions: largest i with storage[i] <= q, else -1.

    ``storage`` is the sorted, sentinel-padded storage-layer key array; the
    index layer is derived from it (every F**l-th key), so the descent's
    answer is by definition ``searchsorted(right) - 1``.
    """
    pos = torch.searchsorted(storage, queries.to(storage.dtype), right=True)
    return pos.to(torch.int32) - 1


def bitonic_sort_ref(keys: torch.Tensor, vals: torch.Tensor):
    """Lexicographic (key, val) sort oracle: two stable argsorts, by val
    and then by key (``jnp.lexsort((vals, keys))``).

    The bitonic network resolves key ties by value; packing the arrival
    index into ``vals`` therefore reproduces the paper's stable Def. 3
    ordering exactly.
    """
    order = torch.argsort(vals, stable=True)
    order = order[torch.argsort(keys[order], stable=True)]
    return keys[order], vals[order]
