"""The measured window's length over the work it finished: `per` is
"sample" (every sample of every whole unit) or "unit" (images or
frames), times `scale`."""


def read(spec, run):
    work = run.samples if spec["per"] == "sample" else run.units
    return run.window_s * spec["scale"] / work if work else None
