"""Seconds from the process's start to the first timed call: imports, data, the kernel library (built on a checkout's first run), warm-up."""


def read(run):
    return run.setup_s
