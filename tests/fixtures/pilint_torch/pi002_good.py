"""Static metadata, static parameters and host-side code — PI002 negatives."""
import torch


def shaped(x, group, span):
    if x.shape[0] > 4 and x.ndim == 1:      # static metadata
        x = torch.cumsum(x, 0)
    if x.dtype == torch.float32 and x.device.type == "cuda":
        x = x * 2
    if x.numel() > 8 or x.size(0) > 8:      # numel() and size are static
        x = x[:8]
    if group is not None:                   # an identity test reads nothing
        x = x + 1
    if span > 2:                            # a static parameter
        return x * int(span)
    if x.config.capacity > x.cfg.fanout:    # the config is host data
        x = x[1:]
    return x


def host_side(x):
    # not a device scope: reading a value on the host is the point here
    return float(x.sum()), x.tolist()
