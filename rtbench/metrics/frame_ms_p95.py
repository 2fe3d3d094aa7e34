"""The 95th percentile of the wall time of every frame in the window, from
the call to the returned image, in ms (linear interpolation between the
order statistics)."""

import numpy as np


def read(run):
    if not run.frames:
        return None
    ms = [(end - start) * 1e3 for start, end, _ in run.frames]
    return float(np.percentile(ms, 95))
