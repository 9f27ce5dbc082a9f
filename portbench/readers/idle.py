"""The device's idle share of the traced window, in %: 100 x (1 - the
union of its operations' intervals / the window's host-clock length)."""

from .. import trace as T


def read(spec, run):
    tr = run.trace
    if tr is None:
        return None
    return 100.0 * (1.0 - T.busy_us(tr.events) / 1e6 / tr.window_s)
