"""Mean MB (1e6 bytes) per request copied from the device to the host, the program's counter bytes_to_host summed over the call."""
from krlsbench import spans


def read(run):
    return spans.counter(run, "bytes_to_host", 1e-6)
