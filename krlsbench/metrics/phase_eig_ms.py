"""Mean ms per fit of model.timings' "eigendecomposition" phase: the adaptive region, its lambda search included; on the streaming route (phase_eig_ms.streaming) the eigensolver's products through K2."""
from krlsbench import readings


def read(run):
    return readings.phase_ms(run, "eigendecomposition")
