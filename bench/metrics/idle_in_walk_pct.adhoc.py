"""idle_in_walk_pct.adhoc: the share of the traced stretch in which no
operation ran on the device while the host's innermost program span was
the staged walk, `repro.walk` or an operator's `repro.op.<Node>`
(profiler trace)."""
from bench import spans

spans.install()


def read(run):
    return spans.idle_pct(run.trace, lambda name: name == "repro.walk"
                          or name.startswith("repro.op."))
