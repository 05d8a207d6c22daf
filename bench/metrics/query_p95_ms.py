"""query_p95_ms: the 95th percentile of the latency of every query due in
the window, from its start to its decoded answer (host clock)."""
from bench import stats


def read(run):
    return stats.percentile(stats.latencies_ms(run), 95)
