"""What a run reads by name: the cell, its configuration, its traffic and
its metrics.

`BENCHMARK.json` at the checkout's root lists the cells (`workloads`), the
configurations and the metrics.  A cell's traffic is its own file,
`workloads/<cell>.json`; a configuration's sizes are
`configs/<config>.json`; a metric is the module `metrics/<metric>.py`,
whose `read(run)` returns its value or None where the run holds nothing
for it to read.  Scene recipes are `scenes/<recipe>.py` (the program's
API) and `reference/scenes/<recipe>.py` (the plain reference).  So a new
cell, configuration, recipe or metric is a new file and an entry in
`BENCHMARK.json`, and no edit of this package.
"""

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Metric:
    name: str
    unit: str
    per_layer: bool
    read: object          # read(run) -> float or None


@dataclass
class Cell:
    name: str
    chips: int
    traffic: dict         # workloads/<name>.json
    config: dict          # configs/<config>.json
    metrics: list         # the Metrics this cell reports, end to end first


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_module(name: str, data_dir: Path = HERE):
    """The reader module `metrics/<name>.py` under data_dir."""
    path = Path(data_dir) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"rtbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recipe(name: str, reference: bool = False):
    """The scene recipe module of a configuration: the program's or the
    reference's."""
    pkg = "rtbench.reference.scenes" if reference else "rtbench.scenes"
    return importlib.import_module(f"{pkg}.{name}")


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json",
              data_dir: Path = HERE) -> Cell:
    """The cell `name` of the benchmark file, with its traffic, its
    configuration and the metrics it reports."""
    bench = _load_json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    traffic = _load_json(Path(data_dir) / "workloads" / f"{name}.json")
    for k in ("config", "traffic"):
        if traffic[k] != entry[k]:
            raise ValueError(f"workloads/{name}.json names {k} "
                             f"{traffic[k]!r}, BENCHMARK.json {entry[k]!r}")
    config = _load_json(Path(data_dir) / "configs" / f"{entry['config']}.json")
    metrics = []
    for per_layer, group in ((False, "end_to_end"), (True, "per_layer")):
        for m in bench[group]:
            if _applies(m, name):
                metrics.append(Metric(m["name"], m["unit"], per_layer,
                                      metric_module(m["name"], data_dir).read))
    return Cell(name, int(entry["chips"]), traffic, config, metrics)
