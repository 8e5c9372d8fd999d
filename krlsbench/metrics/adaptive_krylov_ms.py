"""Mean ms per fit of the program's spans fit/eigendecomposition/krylov on the adaptive route: block-Krylov with its QR and Ritz eigh and the deflated moments, summed over the attempts."""
from krlsbench import spans


def read(run):
    return spans.span_ms(run, "fit/eigendecomposition/krylov")
