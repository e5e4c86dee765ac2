"""An index scope that writes only new tensors — PI003 negatives."""
import torch


class Step:
    def step_single(self, index, ops, keys, vals, span):
        self.count = torch.zeros(1)
        self.count[0] = 1                   # `self` is not an input
        fresh = index.vals.clone()
        fresh[keys] = vals                  # a new tensor of the scope's own
        out = torch.empty_like(vals)
        torch.add(vals, 1, out=out)
        out.add_(span)
        return fresh, out


def helper(index, keys):
    # not a device scope: no contract on its inputs
    keys[0] = index.pn
    return keys
