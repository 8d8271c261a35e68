"""Percentiles as the program's service statistics take them
(``serve/stats.py``, copied and frozen)."""
import math


def nearest_rank(values, q: float) -> float:
    """The smallest sample with at least ``ceil(q * n)`` samples at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("no samples")
    return s[max(0, min(len(s) - 1, math.ceil(q * len(s)) - 1))]


def request_ms(latencies_s, q: float):
    """The ``q`` quantile (nearest rank) in milliseconds of every request
    due in a window, each timed from its due time; a request never answered
    (``None``) ranks above every answer, so a quantile that falls on one has
    no value (``None``)."""
    if not latencies_s:
        return None
    p = nearest_rank([math.inf if x is None else x for x in latencies_s], q)
    return None if math.isinf(p) else p * 1e3
