"""Set-up: from the process's start to the window's start."""


def read(spec, run):
    return run.setup_s
