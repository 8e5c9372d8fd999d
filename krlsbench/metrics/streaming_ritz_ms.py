"""Mean ms per fit of the program's span fit/eigendecomposition/ritz on the streaming route: the Rayleigh-Ritz products, the Ritz eigh, the values' read and lastkeeper."""
from krlsbench import spans


def read(run):
    return spans.span_ms(run, "fit/eigendecomposition/ritz")
