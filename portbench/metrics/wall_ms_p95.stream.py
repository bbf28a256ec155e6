"""95th percentile of every scan's synchronised host time in the
untraced window (numpy's linear percentile)."""

import numpy as np

UNIT = "ms"


def read(run):
    if len(run.step_s) < 20:
        return None
    return float(np.percentile(np.asarray(run.step_s) * 1e3, 95))
