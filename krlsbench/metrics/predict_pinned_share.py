"""Mean % per request of the bytes copied to the host that landed in pinned host memory: 100 x the program's counter bytes_to_host_pinned over bytes_to_host, each summed over the call. A program without the counter reads None."""
from krlsbench import spans


def _share(job_spans):
    if not any("bytes_to_host_pinned" in s.counters for s in job_spans):
        return None
    total = sum(s.counters.get("bytes_to_host", 0) for s in job_spans)
    if not total:
        return None
    return 100.0 * sum(s.counters.get("bytes_to_host_pinned", 0)
                       for s in job_spans) / total


def read(run):
    return spans.mean(run, _share)
