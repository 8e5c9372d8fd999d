"""The 95th percentile of every job's latency (fit + summary) in the window, in seconds."""
from krlsbench import readings


def read(run):
    return readings.p95([j.latency for j in run.window.jobs])
