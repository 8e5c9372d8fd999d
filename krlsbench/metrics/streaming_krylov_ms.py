"""Mean ms per fit of the program's span fit/eigendecomposition/krylov on the streaming route: the start block and the power and Krylov blocks through K2 with their orthogonalization."""
from krlsbench import spans


def read(run):
    return spans.span_ms(run, "fit/eigendecomposition/krylov")
