"""The 99th percentile of the intervals between consecutive frames'
completions, every frame of the window: a CUDA event recorded after each
tick (and one at the window's start), read once after the window."""

import numpy as np


def read(run):
    if not run.frame_ms:
        return None
    return float(np.percentile(np.asarray(run.frame_ms, np.float64), 99))
