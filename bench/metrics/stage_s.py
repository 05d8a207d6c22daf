"""stage_s: building the cell's plans in set-up: `CompiledQuery` and
`compile()` for the embedded engine, each template's first request and
first full batch through the server (host clock)."""


def read(run):
    return run.setup["stage_s"]
