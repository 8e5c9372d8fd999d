"""Milliseconds of the program's library span in the run (host time): loading the kernel library, with nvcc where its counter built is 1. Set-up work, read from the whole log."""
from krlsbench import spans


def read(run):
    log = spans.program_log()
    lib = [s.seconds for s in log or () if s.name == "library"]
    return 1e3 * sum(lib) if lib else None
