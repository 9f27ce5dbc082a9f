"""Kernel time from the traced part of the window: the kernels whose
name matches one of `kernels` (regular expressions), summed, in ms per
traced sample (`per` "sample") or unit ("unit"). None without a trace
or where no such kernel ran."""

from .. import trace as T


def read(spec, run):
    tr = run.trace
    if tr is None:
        return None
    us = T.kernel_us(tr.events, spec["kernels"])
    if us == 0.0:
        return None
    work = tr.samples if spec["per"] == "sample" else tr.units
    return us / 1e3 / work
