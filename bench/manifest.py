"""Finds a cell's parts by name from `BENCHMARK.json`: its configuration
file, its traffic file and the traffic's generator, the client of the
program that the configuration names, and a reader file for each metric.
Adding a configuration, a traffic mix or a metric is adding files and
entries; nothing here names one.

    bench/configs/<config>.json     (the path BENCHMARK.json gives)
    bench/traffic/<traffic>.json    its `kind` names bench/gen/<kind>.py
    bench/clients/<client>.py       the configuration's `client`
    bench/metrics/<metric>.py       a `read(run)` for each metric
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_module(path: Path, name: str):
    """The module of one file of the benchmark, loaded by its path (its
    name may hold dots: a metric's file is named after the metric)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: object

    def read(self, run):
        return self.reader.read(run)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    generator: object
    client: object
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str, reported: set) -> bool:
    """Does `cell` report `metric`: the cells it lists, or without a list
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def _metric(m: dict, bench: Path) -> Metric:
    return Metric(m["name"], m["unit"],
                  load_module(bench / "metrics" / f"{m['name']}.py",
                              f"bench_metric_{m['name']}"))


def _entries(workload: str, root: Path) -> tuple:
    """(BENCHMARK.json, the cell's entry, its configuration's contents)."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[workload]
    conf_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return manifest, w, json.loads((root / conf_entry["file"]).read_text())


def load(workload: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    """The cell `workload` of the benchmark at `root`."""
    manifest, w, config = _entries(workload, root)
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    generator = load_module(bench / "gen" / f"{traffic['kind']}.py",
                            f"bench_gen_{traffic['kind']}")
    client = load_module(bench / "clients" / f"{config['client']}.py",
                         f"bench_client_{config['client']}")
    e2e = [m for m in manifest["end_to_end"]
           if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if _reports(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, generator, client,
                [_metric(m, bench) for m in e2e],
                [_metric(m, bench) for m in layer])
