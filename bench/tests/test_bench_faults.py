"""A run with the timed path broken underneath has to come out not
correct.  Each test drives the whole of a run on the CPU at a small
scale, the harness's look for a chip left out, with one fault planted in
the program: a float altered 1 % where the answer is decoded, or a row
dropped there.  The benchmark's one cell has no training step, no
exchange between chips and no batched pass, so those faults have no place
here; the report service's client, which no cell drives yet, is run the
same way through a cell added as files, with batched passes in it."""
import pytest

from bench.tests.runs import add_server_cell, checkout, run_python

RUN = ("import json, time\n"
       "from pathlib import Path\n"
       "from bench import harness\n"
       "r = harness.execute({cell!r}, 11, 0.5, False, t_start="
       "time.monotonic(), device='cpu', scale=0.01, root=Path({root!r}))\n"
       "print(json.dumps(r))\n")

DECODE = ("import numpy as np\n"
          "from repro_torch.core import compile as c\n"
          "decode = c._decode_frame\n"
          "def broken(*a, **k):\n"
          "    out = decode(*a, **k)\n"
          "{body}"
          "    return out\n"
          "c._decode_frame = broken\n")

SCALED = DECODE.format(body=(
    "    for name, v in out.items():\n"
    "        if v.dtype.kind == 'f':\n"
    "            out[name] = v * np.float32(1.01)\n"))

DROPPED = DECODE.format(body=(
    "    if len(next(iter(out.values()), [])) > 1:\n"
    "        out = {name: v[1:] for name, v in out.items()}\n"))

FAULTS = {"answer-altered": SCALED, "row-dropped": DROPPED}


def _cell(name: str, tmp_path) -> tuple:
    root = checkout(tmp_path)
    if name == "reports":
        add_server_cell(root, outstanding=8)
    return name, str(root)


@pytest.mark.parametrize("cell", ["adhoc-power", "reports"])
def test_a_sound_run_is_correct(cell, tmp_path):
    name, root = _cell(cell, tmp_path)
    r = run_python(RUN.format(cell=name, root=root))
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell", ["adhoc-power", "reports"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_run_is_not_correct(cell, fault, tmp_path):
    name, root = _cell(cell, tmp_path)
    r = run_python(FAULTS[fault] + RUN.format(cell=name, root=root))
    assert r["correct"] is False
    checks = r["checks"]
    assert any(v["value"] > v["limit"] for v in checks.values())
