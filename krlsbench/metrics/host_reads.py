"""Mean per call of the program's counter host_reads summed over the call's spans: reads that make the host wait on the device. Read as host_reads.fit, host_reads.streaming and host_reads.predict."""
from krlsbench import spans


def read(run):
    return spans.counter(run, "host_reads")
