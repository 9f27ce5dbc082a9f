"""A host-clock span of set-up that the frontend recorded under the
name `span` (seconds), or None where the frontend has no such phase."""


def read(spec, run):
    return run.spans.get(spec["span"])
