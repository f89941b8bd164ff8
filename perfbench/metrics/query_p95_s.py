"""95th percentile of the seconds from submit to result, on the client's
clock, over every request of the window that was answered."""
import numpy as np


def read(r):
    return float(np.percentile(r.latencies, 95)) if r.latencies else None
