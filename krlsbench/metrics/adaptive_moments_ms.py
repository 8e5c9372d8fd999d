"""Mean ms per fit of the program's spans fit/eigendecomposition/krylov/moments on the adaptive route over a mesh: the deflated tail moments tr(R^j) of a block-sharded K (R formed block by block, R^2 and R^3 as block products), summed over the attempts; on several cards the longest card's device interval. A program without the span reads None."""
from krlsbench import spans


def read(run):
    return spans.span_ms(run, "fit/eigendecomposition/krylov/moments")
