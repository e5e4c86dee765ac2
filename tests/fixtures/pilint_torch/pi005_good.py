"""Named sentinels and domain bounds under torch — PI005 negatives."""
import torch

from repro_torch.kernels.pi_search import sentinel_for


def pad_value(dtype):
    return torch.full((4,), sentinel_for(dtype))


def domain_floor(dtype):
    return torch.iinfo(dtype).min      # a domain bound, not the sentinel
