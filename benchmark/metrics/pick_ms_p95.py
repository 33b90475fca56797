"""The 95th percentile of `handle_mouse_move`'s host time, the pick with
its one sync, over every move of the traced run's measured window."""

import numpy as np


def read(run):
    d = run.spans.durations("handle_mouse_move")
    if not d:
        return None
    return float(np.percentile(np.asarray(d, np.float64) * 1e3, 95))
