"""Mean ms per fit of model.timings' "coefficients" phase; also read as phase_coefficients_ms.streaming."""
from krlsbench import readings


def read(run):
    return readings.phase_ms(run, "coefficients")
