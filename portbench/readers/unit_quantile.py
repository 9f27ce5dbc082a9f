"""A quantile `q` of the host-clock times of every unit of the window
(each from its call to the end of its work on the device), times
`scale`; numpy's linear interpolation."""

import numpy as np


def read(spec, run):
    if not run.unit_s:
        return None
    return float(np.percentile(run.unit_s, 100.0 * spec["q"])) * spec["scale"]
