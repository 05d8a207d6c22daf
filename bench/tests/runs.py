"""Helpers of the benchmark's tests.  `run_python` runs a piece of Python
in a fresh interpreter with the benchmark and the port on its path, and
reads the JSON of its last line: the benchmark's checks of what a process
loads, and runs of the harness with the program broken underneath, need a
process of their own.  `checkout` copies the benchmark alone, and
`add_server_cell` adds a report-service cell to such a copy the way a
later change would, as new files and new entries."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIX = ("q1", "q3", "q6", "q12", "q14", "q19")


def run_python(code: str, timeout: float = 900):
    script = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
              f"{str(ROOT / 'src')!r}]\n"
              "import torch; torch.set_num_threads(1)\n" + code)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=timeout, cwd=ROOT)
    if out.returncode != 0:
        raise AssertionError(f"exit {out.returncode}:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def traffic(name: str) -> dict:
    return json.loads((ROOT / "bench" / "traffic" / f"{name}.json")
                      .read_text())


def reports_mix(**loop) -> dict:
    """A mix of the six parameterized templates as a later cell would add
    it: the power stream's clause 2.4 parameters, the template uniform."""
    params = traffic("power")["params"]
    return dict(kind="tpch_requests", mix={q: 1 for q in SIX},
                params={q: params[q] for q in SIX}, **loop)


def checkout(tmp_path: Path) -> Path:
    """A copy of `BENCHMARK.json` and `bench/` alone."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def server_config() -> dict:
    """The embedded configuration served through the port's QueryServer."""
    conf = json.loads((ROOT / "bench/configs/tpch-sf1-embedded.json")
                      .read_text())
    return dict(conf, name="tpch-sf1-reports", client="server",
                server={"budget": 1024})


def add_server_cell(root: Path, outstanding: int) -> str:
    """Adds the cell `reports` to the benchmark at `root`: the six
    templates through the server, a closed loop with `outstanding`
    requests in flight, reporting `requests_per_s`."""
    (root / "bench/configs/tpch-sf1-reports.json").write_text(
        json.dumps(server_config()))
    (root / "bench/traffic/reports.json").write_text(json.dumps(
        reports_mix(loop="closed", outstanding=outstanding, warmup_s=0.5)))
    (root / "bench/metrics/requests_per_s.py").write_text(
        "from bench import stats\n\n\n"
        "def read(run):\n    return stats.completed_per_s(run)\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tpch-sf1-reports", "source": "test",
                         "file": "bench/configs/tpch-sf1-reports.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "reports", "config": "tpch-sf1-reports",
                           "traffic": "reports", "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": "requests_per_s", "unit": "requests/s",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["reports"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return "reports"
