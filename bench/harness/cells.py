"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout names each cell's configuration and traffic mix, and each
per-layer metric; each sits in a file of its own under ``bench/``:

* ``bench/configs/<config>.json``: the configuration: its published keys,
  the program's departures from them, and each regime's cut;
* ``bench/traffic/<traffic>.json``: one traffic mix, whose ``entry`` names
  the driver that serves it (``bench/entries/<entry>.py``);
* ``bench/limits/<cell>.json``: the cell's comparison limits;
* ``bench/metrics/<metric>.py``: one per-layer metric's reader.

A later cell or metric is added as files and entries only."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    #: the cell's end-to-end metric entries of ``BENCHMARK.json``
    end_to_end: List[Dict]
    #: the cell's per-layer metric entries
    per_layer: List[Dict]
    bench_dir: str = BENCH


def _applies(metric: Dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root: str = ROOT, bench_dir: str = BENCH) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    ``KeyError`` for a cell the file does not name and ``OSError`` for a
    missing file."""
    spec = benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, e2e_names)]
    return from_files(name, w["config"], w["traffic"], e2e, per_layer,
                      w["chips"], bench_dir)


def from_files(name: str, config: str, traffic: str, end_to_end: List[Dict],
               per_layer: List[Dict], chips: int = 1,
               bench_dir: str = BENCH) -> Cell:
    """A cell from its configuration, traffic and limits files by name
    (the CPU tests also build a cell that ``BENCHMARK.json`` does not
    name yet this way)."""
    return Cell(
        name=name, chips=chips,
        config=load_json(os.path.join(bench_dir, "configs",
                                      f"{config}.json")),
        traffic=dict(load_json(os.path.join(bench_dir, "traffic",
                                            f"{traffic}.json")),
                     name=traffic),
        limits=load_json(os.path.join(bench_dir, "limits", f"{name}.json")),
        end_to_end=end_to_end, per_layer=per_layer, bench_dir=bench_dir)


def as_run(config: Dict, regime: str, test: bool = False) -> Dict:
    """The configuration as a regime runs it: the published keys, the
    value the program's block runs for each of its ``departures``, then
    the regime's layer count; with ``test``, the CPU tests' small widths
    (``test_widths``) over those."""
    out = {k: v for k, v in config.items()
           if k not in ("regimes", "departures", "test_widths")}
    out.update({k: d["runs"] for k, d in config.get("departures",
                                                     {}).items()})
    out.update({k: v for k, v in config["regimes"][regime].items()
                if k != "deployment"})
    if test:
        out.update(config["test_widths"])
    out["test_widths_keys"] = sorted(config["test_widths"]) if test else []
    return out


def traffic_as_run(traffic: Dict, test: bool = False) -> Dict:
    """A traffic mix's parameters; with ``test``, its ``test`` overrides
    (small shapes for the CPU tests)."""
    out = {k: v for k, v in traffic.items() if k != "test"}
    if test:
        out.update(traffic.get("test", {}))
    return out


def load_module(path: str, name: Optional[str] = None):
    """A Python file loaded by path (file names may hold dots, as metric
    names do)."""
    mod_name = name or "bench_file_" + os.path.basename(path)[:-3].replace(
        ".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(cell: Cell):
    return load_module(os.path.join(cell.bench_dir, "entries",
                                    f"{cell.traffic['entry']}.py"))


def metric_reader(cell: Cell, metric: str):
    return load_module(os.path.join(cell.bench_dir, "metrics",
                                    f"{metric}.py"))
