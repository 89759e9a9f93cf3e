"""What a run is asked to do, found by name from `BENCHMARK.json`.

A cell (`workloads` entry) names a configuration and a traffic mix. The
configuration's file is the one `configs` gives it; the traffic mix is
`traffic/<traffic>.json`; the limits of the cell's correctness check are
`limits/<cell>.json`; each per-layer metric is read by
`metrics/<metric>.py`. The traffic mix names its entry, the step a run
drives, made by `entries/<entry>.py`; each model entry of a configuration
names its model, built by `models/<name>.py`. Adding any of them adds a
file and edits none.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import os
from types import ModuleType
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]  # the per-layer metrics this cell reports


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: str = None, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of the spec (the root's `BENCHMARK.json` by default),
    with its configuration, traffic mix and limits read from `bench_dir`."""
    spec = _read(spec_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_path = configs[w["config"]]["file"]
    config = _read(cfg_path if os.path.isabs(cfg_path) else os.path.join(os.path.dirname(bench_dir), cfg_path))
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, traffic_name=w["traffic"], chips=w["chips"], config=config,
                traffic=_read(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")),
                limits=_read(os.path.join(bench_dir, "limits", f"{name}.json")), end_to_end=e2e,
                per_layer=per_layer)


@functools.lru_cache(maxsize=None)
def _module(kind: str, name: str, bench_dir: str) -> ModuleType:
    """The file `<bench_dir>/<kind>/<name>.py`, loaded once."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} file {name}.py in {os.path.join(bench_dir, kind)}")
    mod_spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: str = BENCH_DIR) -> Callable:
    """`read(run)` of `metrics/<metric>.py`: the metric's value from a
    run's record, or None where the run holds nothing for it."""
    return _module("metrics", metric, bench_dir).read


def entry(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """`entries/<name>.py`, whose `make(cfg, traffic, seed, device)` builds
    the object a run drives: `setup()`, `window(seconds)`, `profile(n)`,
    `release()`, `check(limits)`, and where it holds files, `close()`."""
    return _module("entries", name, bench_dir)


def model(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """`models/<name>.py` of a configuration's model entry (its `name`):
    `program(m, device)`, the port's module built on `device`;
    `reference(m)`, the plain float32 module with the port's parameter
    names; `tokens(m)`, the tokens of one clip; `flops_per_clip(m)`, the
    forward operations on one clip."""
    return _module("models", name, bench_dir)


def read_per_layer(cell: Cell, run: Dict, bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    """Each per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"], bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
