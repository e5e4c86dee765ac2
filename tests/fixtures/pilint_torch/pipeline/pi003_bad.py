"""In-place writes to an index scope's inputs — PI003 positives.

The dispatcher reads the pre-window state again (breaker rollback, ranges
enqueued before the point execute), so the point execute must never
write to its input index.
"""
import torch


def execute_impl(index, ops, keys, vals):
    index.vals.index_put_((keys,), vals)    # expect: PI001  # expect: PI003
    ops.zero_()                                     # expect: PI003
    torch.relu_(vals)                               # expect: PI003
    index.pkeys[0] = 1                      # expect: PI001  # expect: PI003
    keys[ops > 0] += 1                              # expect: PI003
    torch.add(vals, 1, out=index.pvals)     # expect: PI001  # expect: PI003
    return index
