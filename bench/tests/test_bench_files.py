"""Every cell and metric of ``BENCHMARK.json`` finds its files by name,
and a cell or metric added as files and entries only is picked up."""
import json
import os
import re
import shutil

import pytest

from bench.tests._util import BENCH, ROOT
from bench.harness import cells

SPEC = cells.benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_finds_its_files(cell):
    c = cells.load_cell(cell)
    assert c.chips == 1
    assert cells.entry_module(c).run
    assert c.limits["numbers"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert cells.metric_reader(c, m["name"]).read


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_has_a_reader(metric):
    assert os.path.exists(os.path.join(BENCH, "metrics", f"{metric}.py"))


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and 1 <= SPEC["run_seconds"] <= 51
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"] == f"bench/configs/{c['name']}.json"
        conf = cells.load_json(os.path.join(ROOT, c["file"]))
        assert conf["source"] == c["source"]
        cuts = {k for r in conf["regimes"].values() for k in r
                if k != "deployment" and r[k] != conf[k]}
        assert sorted(c["reduced"]) == sorted(cuts)
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
            assert key not in conf.get("departures", {})
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and 0 < len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_added_files_are_picked_up(tmp_path):
    """A new traffic mix, limits and metric reader, with their entries,
    make a new cell and metric without editing a file."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "stablelm_12b.train_2k",
                              "config": "stablelm_12b",
                              "traffic": "train_8x2048", "chips": 1,
                              "why": "a further cell added as files"})
    spec["per_layer"].append({"name": "step_count.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "model step",
                              "moves": "train_tokens_per_s",
                              "workloads": ["stablelm_12b.train_2k"]})
    spec["end_to_end"][0]["workloads"].append("stablelm_12b.train_2k")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    mix = json.loads((root / "bench/traffic/train_4x4096.json").read_text())
    mix.update(batch=8, seq=2048)
    (root / "bench/traffic/train_8x2048.json").write_text(json.dumps(mix))
    shutil.copy(root / "bench/limits/stablelm_12b.train_4k.json",
                root / "bench/limits/stablelm_12b.train_2k.json")
    (root / "bench/metrics/step_count.train.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    c = cells.load_cell("stablelm_12b.train_2k", root=str(root),
                        bench_dir=str(root / "bench"))
    assert c.traffic["batch"] == 8 and c.traffic["seq"] == 2048
    assert "step_count.train" in [m["name"] for m in c.per_layer]
    assert cells.metric_reader(c, "step_count.train").read(
        {"steps": 3}) == 3.0
    assert [m["name"] for m in c.end_to_end] == ["train_tokens_per_s",
                                                 "setup_s"]
