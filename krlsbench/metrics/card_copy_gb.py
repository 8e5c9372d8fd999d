"""Mean GB (1e9 bytes) per fit copied from one card to another: the program's counter bytes_between_cards summed over the call (shards, blocks and slabs of a mesh that move between its cards, and what a process sends to another's). A program without the counter reads None."""
from krlsbench import spans


def _gb(job_spans):
    if not any("bytes_between_cards" in s.counters for s in job_spans):
        return None
    return 1e-9 * sum(s.counters.get("bytes_between_cards", 0)
                      for s in job_spans)


def read(run):
    return spans.mean(run, _gb)
