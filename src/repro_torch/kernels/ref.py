"""Plain oracles for the kernels, in stock PyTorch ops.

Counterpart of ``repro.kernels.ref``: each kernel has an exact reference
here, written independently of the kernel's own plain version; the tests
hold the kernels and their plain versions to these bit for bit (the
integer kernels) or within a stated tolerance (attention).
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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int | None = None):
    """Attention with the whole (Sq, Sk) score matrix materialized, in
    float32: the naive oracle of ``tests/test_flash_kernel.py``.
    q (B,Sq,H,D), k/v (B,Sk,KV,D), KV heads broadcast to H; query
    positions start at 0."""
    B, Sq, H, D = q.shape
    rep = H // k.shape[2]
    kk = k.float().repeat_interleave(rep, dim=2)
    vv = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / D ** 0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vv)
