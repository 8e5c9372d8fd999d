"""Mean ms per fit of the program's span fit/kernel/prepare (validation, the binary-column scan, standardization, the copies to the device): phase_kernel_ms without K1. Read as fit_prepare_ms and fit_prepare_ms.streaming."""
from krlsbench import spans


def read(run):
    return spans.span_ms(run, "fit/kernel/prepare")
