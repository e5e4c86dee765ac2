"""Host round-trips inside a device scope — PI002 positives."""
import numpy as np
import torch


def hot(x, n):
    if x > 0:                                       # expect: PI002
        x = x + 1
    total = x.sum().item()                          # expect: PI002
    host = np.asarray(x)                            # expect: PI002
    rows = x.tolist()                               # expect: PI002
    back = x.cpu()                                  # expect: PI002
    arr = back.numpy()                              # expect: PI002
    torch.cuda.synchronize()                        # expect: PI002
    return x, total, host, rows, arr, int(x) * n    # expect: PI002


def step(index, ops):
    due = (index.pn > 4) | ops.any()
    if bool(due):                                   # expect: PI002
        index = index.rebuilt()
    while index.pn > 0:                             # expect: PI002
        index = index.drained()
    return float(index.n)                           # expect: PI002
