"""`BENCHMARK.json` and the files it names: the contract's shape, lookup by
name, and a cell, traffic mix, configuration and per-layer metric added by
new files alone."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from harness import spec
from harness.report import END_TO_END
from harness.spec import BENCH_DIR, ROOT

from _tiny import tiny_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent_dim|head|mlp_ratio|experts_per")


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_meets_the_contract():
    s = _spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"] and s["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= s["run_seconds"] <= 51
    # the full check with 24 cells fits its time
    assert (2 + 14 * 24) * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in s["configs"]}
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert not any(WIDTHS.search(k) for k in c["reduced"])
    cells = {w["name"]: w for w in s["workloads"]}
    assert len(cells) == len(s["workloads"]) and sum(w["chips"] == 4 for w in s["workloads"]) <= 1
    assert len({(w["config"], w["traffic"]) for w in s["workloads"]}) == len(cells)
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert {c["name"] for c in s["configs"]} == {w["config"] for w in s["workloads"]}
    metrics = s["end_to_end"] + s["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert m["name"] in END_TO_END
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert os.path.isfile(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"))
        reporting = [c for c in cells if "workloads" not in e2e[m["moves"]] or c in e2e[m["moves"]]["workloads"]]
        assert set(m["workloads"]) <= set(reporting)
    for name in cells:
        cell = spec.load_cell(name)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", [w["name"] for w in _spec()["workloads"]])
def test_a_cell_finds_its_files_by_name(name):
    cell = spec.load_cell(name)
    w = next(w for w in _spec()["workloads"] if w["name"] == name)
    assert cell.config["name"] == w["config"] and cell.traffic_name == w["traffic"]
    assert callable(spec.entry(cell.traffic["entry"]).make)
    assert all(callable(getattr(spec.model(cell.config[key]["name"]), f))
               for key in ("model", "teacher") if cell.config.get(key)
               for f in ("program", "reference", "tokens", "flops_per_clip"))
    assert cell.limits and all(callable(spec.reader(m["name"])) for m in cell.per_layer)


def test_a_new_cell_config_traffic_and_metric_are_files_only(tmp_path):
    spec_path, bench = tiny_bench(str(tmp_path))
    with open(spec_path) as f:
        s = json.load(f)
    # a new configuration, traffic mix, limits and per-layer metric: new files
    src = s["configs"][0]
    shutil.copy(os.path.join(str(tmp_path), src["file"]), os.path.join(bench, "configs", "dummy-config.json"))
    shutil.copy(os.path.join(bench, "traffic", "slot_train_b12.json"), os.path.join(bench, "traffic", "dummy_mix.json"))
    shutil.copy(os.path.join(bench, "limits", "slot-k400-train.json"), os.path.join(bench, "limits", "dummy-cell.json"))
    with open(os.path.join(bench, "metrics", "dummy_count.train.py"), "w") as f:
        f.write("def read(run):\n    return 7.0 if run['record']['kind'] == 'train' else None\n")
    s["configs"].append({**src, "name": "dummy-config", "file": "benchmark/configs/dummy-config.json"})
    s["workloads"].append({"name": "dummy-cell", "config": "dummy-config", "traffic": "dummy_mix", "chips": 1,
                           "why": "a cell added by files alone"})
    s["per_layer"].append({"name": "dummy_count.train", "unit": "count", "better": "lower",
                           "source": "program_counter", "layer": "device", "moves": "train_clips_per_s",
                           "workloads": ["dummy-cell"]})
    with open(spec_path, "w") as f:
        json.dump(s, f)
    cell = spec.load_cell("dummy-cell", spec_path, bench)
    assert cell.traffic["entry"] == "slot_train" and cell.config["model"]["embed_dim"] == 64
    assert [m["name"] for m in cell.per_layer] == ["dummy_count.train"]
    got = spec.read_per_layer(cell, {"record": {"kind": "train"}}, bench)
    assert got == {"dummy_count.train": {"value": 7.0, "unit": "count"}}
    # the other cells do not report it
    assert "dummy_count.train" not in [m["name"] for m in spec.load_cell("slot-k400-train", spec_path, bench).per_layer]
