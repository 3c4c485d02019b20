"""The 90th percentile (linear interpolation between order statistics),
over every evaluate completed in the window, of the host-clock time from
the call to its return, in ms."""

import numpy as np


def read(run):
    if not run.evals:
        return None
    return float(np.percentile([1e3 * (e.ret - e.call) for e in run.evals], 90))
