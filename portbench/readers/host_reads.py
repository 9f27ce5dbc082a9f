"""The device-to-host copies of the traced window per traced sample
(`per` "sample") or unit ("unit")."""

from .. import trace as T


def read(spec, run):
    tr = run.trace
    if tr is None:
        return None
    work = tr.samples if spec["per"] == "sample" else tr.units
    return T.host_reads(tr.events) / work
