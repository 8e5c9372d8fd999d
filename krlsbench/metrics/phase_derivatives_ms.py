"""Mean ms per fit of model.timings' "derivatives" phase; also read as phase_derivatives_ms.streaming."""
from krlsbench import readings


def read(run):
    return readings.phase_ms(run, "derivatives")
