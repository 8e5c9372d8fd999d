"""Mean ms per fit of the program's spans fit/eigendecomposition/check on the adaptive route: the one copy to the host, the capture plan and the f64 oracle, summed over the attempts."""
from krlsbench import spans


def read(run):
    return spans.span_ms(run, "fit/eigendecomposition/check")
