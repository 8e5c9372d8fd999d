"""Mean ms per fit of the program's spans fit/eigendecomposition/bounds on the adaptive route: the tail quadrature and both completed-spectrum bisections on the device, summed over the attempts."""
from krlsbench import spans


def read(run):
    return spans.span_ms(run, "fit/eigendecomposition/bounds")
