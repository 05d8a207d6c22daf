"""device_idle_pct.adhoc: the share of the traced stretch in which no
operation ran on the device (profiler trace)."""
from bench import stats


def read(run):
    return stats.idle_pct(run.trace)
