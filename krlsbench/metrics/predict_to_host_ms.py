"""Mean ms per request of the program's spans predict/to_host: newdataK, the predictions and the SEs to the host as float64, every block summed."""
from krlsbench import spans


def read(run):
    return spans.span_ms(run, "predict/to_host")
