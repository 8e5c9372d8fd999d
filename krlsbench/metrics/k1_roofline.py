"""K1's share of its roofline in the traced jobs: the launches' least time (roofline.py) over their device time, percent. Read as k1_roofline.fit (the symmetric build) and k1_roofline.predict (the cross entry)."""
from krlsbench import readings


def read(run):
    return readings.roofline_pct(run, "k1")
