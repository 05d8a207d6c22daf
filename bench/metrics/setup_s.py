"""setup_s: from the start of the process to the opening of the window:
generation, loading, staging and warm-up (host clock)."""


def read(run):
    return run.setup["setup_s"]
