"""The 95th percentile of every predict request's latency in the window, in milliseconds."""
from krlsbench import readings


def read(run):
    p = readings.p95([j.latency for j in run.window.jobs])
    return None if p is None else 1e3 * p
