"""95th percentile (nearest rank) of every request due in the window,
each timed from its due time to its answer; a request never answered
counts as missing every limit, so a tail that falls on one has no value."""
from perfbench.stats import request_ms


def read(run):
    return request_ms(run.rec.get("latencies_s"), 0.95)
