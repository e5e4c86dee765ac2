"""The 99th percentile of the latencies of every op answered in the window,
from each latency (issue to the retirement that answered it), in ms."""
import numpy as np


def read(run):
    _, lat = run.answered_in_window()
    return float(np.percentile(lat, 99)) * 1e3 if lat.size else None
