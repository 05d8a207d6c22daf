"""queries_per_s: queries answered inside the window over its seconds
(host clock; the embedded stream)."""
from bench import stats


def read(run):
    return stats.completed_per_s(run)
