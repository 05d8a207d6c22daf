"""submit_host_ms.reports: host milliseconds a request in the program's
`repro.serve.submit` span, the server's admission, keying and windowing of
one request in the sender's thread, over the requests whose span lies
wholly in the traced stretch (profiler trace).  Nothing where the program
emits no such span."""
from bench import spans

spans.install()


def read(run):
    return spans.host_ms(run.trace, "repro.serve.submit")
