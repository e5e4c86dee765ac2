"""Inline sentinel construction under torch — PI005 positives."""
import torch


def pad_value(dtype):
    return torch.iinfo(dtype).max                   # expect: PI005


def pad_i32():
    return torch.full((4,), torch.iinfo(torch.int32).max)   # expect: PI005
