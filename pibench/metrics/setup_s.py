"""Process start to the first timed op: imports, the loaded records, the
index's build, the traffic, and the warm-up windows that build and load
every kernel."""


def read(run):
    return run.setup_s
