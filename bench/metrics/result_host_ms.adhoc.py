"""result_host_ms.adhoc: host milliseconds a query in the program's
`repro.result.copy` and `repro.result.decode` spans, the answer's copy
to the host and its decode, over the queries whose request span lies
wholly in the traced stretch (profiler trace)."""
from bench import spans

spans.install()


def read(run):
    return spans.host_ms(run.trace, "repro.result.copy",
                         "repro.result.decode")
