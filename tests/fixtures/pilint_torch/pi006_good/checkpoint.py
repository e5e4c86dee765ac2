"""Every snapshot effect under a registered crash point — PI006 negatives."""
import os

import numpy as np

from repro_torch.faults import faultpoint


def save(tmp, final, leaves):
    np.savez(os.path.join(tmp, "host0.npz"), *leaves)
    faultpoint("ckpt.mid_write")
    faultpoint("ckpt.pre_rename")
    os.rename(tmp, final)


def restore(path):
    # no durable I/O at all: nothing to cover
    return dict(np.load(path))
