"""kernels_per_query.adhoc: CUDA kernels in the traced stretch over the
queries that started and answered inside it (profiler trace)."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    n = sum(1 for r in run.requests
            if r.ok and r.sent >= tr.t0 and r.done <= tr.t1)
    return tr.kernels / n if n and tr.kernels else None
