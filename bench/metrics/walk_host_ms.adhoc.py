"""walk_host_ms.adhoc: host milliseconds a query in the program's
`repro.walk` span, the staged walk's enqueue of every operator's work,
over the queries whose request span lies wholly in the traced stretch
(profiler trace)."""
from bench import spans

spans.install()


def read(run):
    return spans.host_ms(run.trace, "repro.walk")
