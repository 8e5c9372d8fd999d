"""Mean ms per fit of model.timings' "kernel" phase: input preparation and the kernel build (K1)."""
from krlsbench import readings


def read(run):
    return readings.phase_ms(run, "kernel")
