"""engine_kernels_roofline.adhoc: the least time of the engine entry points'
calls at the HBM peak (their operand and output bytes over 3.35 TB/s) over
the device time the profiler links to them, in the traced stretch."""
from bench import stats


def read(run):
    return stats.roofline_pct(run.trace)
