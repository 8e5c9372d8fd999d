"""Mean ms per request of the program's span predict/prepare: the re-standardization of the training X and of newdata and the copies to the device."""
from krlsbench import spans


def read(run):
    return spans.span_ms(run, "predict/prepare")
