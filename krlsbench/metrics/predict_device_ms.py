"""Mean ms per request of the program's spans predict/kernel (the K1 cross launches) and predict/products (the fitted values and the SEs' quadratic form), every block of the blocked path summed."""
from krlsbench import spans


def read(run):
    return spans.span_ms(run, "predict/kernel", "predict/products")
