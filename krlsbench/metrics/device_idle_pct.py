"""Percent of the traced jobs' untraced wall time in which the device ran nothing: 100 x (1 - device busy time of the traced jobs, the mean over the cell's cards / the wall time the same jobs take untraced). Read as device_idle_pct.fit, .streaming and .predict."""
from krlsbench import readings


def read(run):
    return readings.idle_pct(run)
