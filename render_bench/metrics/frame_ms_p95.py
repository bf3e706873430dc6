"""The 95th percentile of the window's frame intervals: the device time
between the CUDA events recorded after successive frames (the first from
one recorded before the window), linear between order statistics."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.intervals_ms, np.float64), 95))
