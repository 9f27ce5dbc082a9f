"""The mean host-clock time of a call the frontend timed in every unit
(`call`: its name in the frontend's `calls`), over the units of the
window that ran untraced, times `scale`."""


def read(spec, run):
    times = run.calls.get(spec["call"], [])[run.traced_units:]
    return sum(times) / len(times) * spec["scale"] if times else None
