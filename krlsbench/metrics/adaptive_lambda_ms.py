"""Mean ms per fit of the program's spans fit/eigendecomposition/lambda_search on the adaptive route: the golden search and solve of every attempt, and the re-run after an oracle mismatch."""
from krlsbench import spans


def read(run):
    return spans.span_ms(run, "fit/eigendecomposition/lambda_search")
