"""Exact-domain arithmetic kept integer under torch — PI004 negatives."""
import torch


def plan(capacity, batch):
    hi = torch.div(capacity, 2, rounding_mode="floor")   # integer division
    cap = -(-batch * 768 // 1024)            # integer ceil, no float detour
    return hi, cap


def unrelated(ratio):
    return torch.ceil(ratio / 2)             # no exact-domain name involved
