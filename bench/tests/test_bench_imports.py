"""What the benchmark loads.  Each check runs in a fresh interpreter and
compares the top-level name of every loaded module (the part before the
first dot) whole: `repro_torch` begins with `repro` and is not it."""
from bench.tests.runs import run_python

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

LOADED = ("import json, sys\n"
          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")


def test_the_reference_loads_neither_jax_nor_either_package():
    names = set(run_python(
        "import bench.reference, bench.tpchgen, bench.compare\n" + LOADED))
    assert not names & (FORBIDDEN | {"repro_torch"})


def test_every_cell_loads_no_jax_and_not_the_jax_package():
    names = set(run_python(
        "import json, time\n"
        "from bench import harness, manifest\n"
        "cells = json.loads((manifest.ROOT / 'BENCHMARK.json').read_text())"
        "['workloads']\n"
        "for w in cells:\n"
        "    harness.execute(w['name'], 3, 0.5, True, t_start="
        "time.monotonic(), device='cpu', scale=0.01)\n"
        "import bench.sweep, bench.control, bench.run\n"
        "import bench.clients.server, bench.clients.embedded\n" + LOADED))
    assert "repro_torch" in names
    assert not names & FORBIDDEN


def test_a_run_with_the_jax_package_loaded_gives_no_result():
    out = run_python(
        "import json, sys, types\n"
        "from bench import harness\n"
        "sys.modules['repro.core'] = types.ModuleType('repro.core')\n"
        "try:\n"
        "    harness.execute('adhoc-power', 3, 0.2, False, t_start=0.0, "
        "device='cpu', scale=0.01)\n"
        "except harness.Failed as e:\n"
        "    print(json.dumps(str(e)))\n")
    assert "repro" in out
