"""Snapshot writes outside fault-point coverage — PI006 positives."""
import os

import numpy as np

from repro_torch.faults import faultpoint


def save(tmp, final, leaves):
    np.savez(os.path.join(tmp, "host0.npz"), *leaves)   # expect: PI006
    os.rename(tmp, final)                               # expect: PI006


def publish(tmp, final):
    faultpoint("ckpt.not_registered")                   # expect: PI006
    os.replace(tmp, final)                              # expect: PI006
