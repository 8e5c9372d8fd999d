"""Mean ms of the summary() call per job (the benchmark's own span). Read as summary_ms and summary_ms.streaming."""
from krlsbench import readings


def read(run):
    return readings.span_ms(run, "summary")
