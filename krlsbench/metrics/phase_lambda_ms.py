"""Mean ms per fit of model.timings' "lambda_search" phase (the streaming route; the adaptive route searches inside its eigensolver's phase)."""
from krlsbench import readings


def read(run):
    return readings.phase_ms(run, "lambda_search")
