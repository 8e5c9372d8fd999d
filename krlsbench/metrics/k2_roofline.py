"""K2's share of its roofline in the traced fits, percent."""
from krlsbench import readings


def read(run):
    return readings.roofline_pct(run, "k2")
