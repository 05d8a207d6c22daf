"""idle_in_result_pct.adhoc: the share of the traced stretch in which no
operation ran on the device while the host's innermost program span was
the answer's copy or decode, `repro.result.*` (profiler trace)."""
from bench import spans

spans.install()


def read(run):
    return spans.idle_pct(run.trace,
                          lambda name: name.startswith("repro.result."))
