"""Seconds per job (fit + summary): the whole window over the jobs it completed. Read as fit_s (the dense route) and fit_s.streaming."""
from krlsbench import readings


def read(run):
    return readings.per_job_s(run)
