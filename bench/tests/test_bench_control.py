"""The check's control: the plain reference in bfloat16, put in the
program's place over a cell's requests, has to come out not correct.
On the card `bench/control.py` reads it at each cell's own size; here at
a scale a test run can hold."""
import json

import pytest

from bench import control, manifest

CELLS = [w["name"] for w in json.loads(
    (manifest.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    got = control.readings(cell, 5, "cpu", scale=0.02, n_requests=120)
    limits = manifest.load(cell).config["limits"]
    assert got["bindings"] > 0
    assert got["answers_wrong"] > limits["answers_wrong"] \
        or got["float_gap"] > limits["float_gap"]
