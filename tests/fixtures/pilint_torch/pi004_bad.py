"""Float math truncated back onto exact integer domains, torch's — PI004."""
import torch


def plan(capacity, batch, next_seq):
    hi = torch.ceil(capacity / 2)                   # expect: PI004
    lo = torch.floor(batch / 3 * capacity)          # expect: PI004
    pad = torch.round(next_seq / 8)                 # expect: PI004
    return hi, lo, pad
