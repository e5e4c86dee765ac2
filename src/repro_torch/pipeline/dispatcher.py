"""One point-op window through one PI shard: execute, then rebuild if due.

Counterpart of ``_step_single`` in ``repro.pipeline.dispatcher``.  The JAX
package fuses execute, the overflow snapshot and the rebuild-if-due into
one device program with ``lax.cond``.  PyTorch runs eagerly, so here the
branch is a host read of ``needs_rebuild``: one device-to-host sync per
window, and one more on the due branch, where ``rebuild_tier`` reads
``incremental_fits`` to pick the tier.  Collector, windowed dispatch,
WAL, recovery and overload control are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core import index as pi


def step_single(index: pi.PIIndex, ops, keys, vals):
    """Execute one window + overflow snapshot + rebuild-if-due.

    Returns ``(new_index, found, val, ovf, due, incr, pn)`` as the JAX
    step does: ``ovf`` is the pending-overflow flag right after execute
    (a rebuild resets it on the state), ``pn`` the pending fill before
    any rebuild, ``due`` whether a rebuild ran and ``incr`` whether it
    took the incremental tier.  The input index is left untouched.
    """
    new_index, (found, val) = pi.execute_impl(index, ops, keys, vals)
    ovf = new_index.overflow
    pn = new_index.pn  # fill high-water: post-rebuild pn is ~always zero
    due = pi.needs_rebuild(new_index)
    incr = False
    if bool(due):
        new_index, incr = pi.rebuild_tier(new_index)
    incr = torch.tensor(incr, device=new_index.device)
    return new_index, found, val, ovf, due, incr, pn
