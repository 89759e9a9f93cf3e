"""What a later configuration brings as new files alone: a model under a
name of its own, an entry under a name of its own, a traffic mix, limits
and a configuration, added to a tiny
copy of the benchmark, with a cell in the copy's `BENCHMARK.json`. The
copy runs the cell traced and correct with its own harness, and every
file that was there keeps its bytes."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

from harness.entries import REF_ROWS
from harness.spec import ROOT

from _tiny import tiny_bench

SEED = 2 ** 31 + 59
MODEL = '''"""The port's slot ViT under a name of its own."""

import torch

from harness import roofline
from harness.entries import program_kwargs
from reference import model as ref_model


def program(m, device):
    from devias_tpu_torch.nn import SlotViT

    with torch.device(device):
        return SlotViT(**program_kwargs(m))


def reference(m):
    return ref_model.SlotViT(m)


def tokens(m):
    return roofline.patch_tokens(m)


def flops_per_clip(m):
    return roofline.vit_flops_per_clip(tokens(m), m["embed_dim"], m["depth"], m.get("mlp_ratio", 4.0))
'''
ENTRY = '''"""The slot train step, by the entry that makes it."""

from harness import spec


def make(cfg, traffic, seed, device):
    return spec.entry("slot_train").make(cfg, traffic, seed, device)
'''
# the copy's own harness, the port from the repository; the reference's
# block size seen as it runs
RUN = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import run
import reference.train as ref_train
from harness import spec

assert spec.BENCH_DIR == {bench!r}
rows = []
run_train = ref_train.run_train
ref_train.run_train = lambda *a, **kw: rows.append(a[5]) or run_train(*a, **kw)
result = run.run_cell(spec.load_cell("tiny-new-cell"), {seed}, 0.3, True, "cpu")
print(json.dumps({{"result": result, "rows": rows}}))
"""


def _hashes(top: str) -> dict:
    out = {}
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _write(path: str, text: str) -> None:
    assert not os.path.exists(path), path
    with open(path, "w") as f:
        f.write(text)


def test_a_model_and_an_entry_are_new_files_only(tmp_path):
    tmp = str(tmp_path)
    spec_path, bench = tiny_bench(tmp)
    before = _hashes(tmp)
    with open(spec_path) as f:
        s = json.load(f)
    src = next(c for c in s["configs"] if c["name"] == "devias-slot-vitb16-k400")
    with open(os.path.join(tmp, src["file"])) as f:
        cfg = json.load(f)
    cfg["model"]["name"] = "tiny_new_slot_vit"
    with open(os.path.join(bench, "traffic", "slot_train_b12.json")) as f:
        traffic = json.load(f)
    traffic.update(entry="tiny_new_entry")
    with open(os.path.join(bench, "limits", "slot-k400-train.json")) as f:
        limits = f.read()
    _write(os.path.join(bench, "models", "tiny_new_slot_vit.py"), MODEL)
    _write(os.path.join(bench, "entries", "tiny_new_entry.py"), ENTRY)
    _write(os.path.join(bench, "traffic", "tiny_new_mix.json"), json.dumps(traffic))
    _write(os.path.join(bench, "limits", "tiny-new-cell.json"), limits)
    _write(os.path.join(bench, "configs", "tiny-new-config.json"), json.dumps(cfg))
    s["configs"].append({**src, "name": "tiny-new-config", "file": "benchmark/configs/tiny-new-config.json"})
    s["workloads"].append({"name": "tiny-new-cell", "config": "tiny-new-config", "traffic": "tiny_new_mix",
                           "chips": 1, "why": "a model and an entry added by files alone"})
    for m in s["per_layer"]:
        if m["name"] in ("mfu.train", "host_ms.train"):
            m["workloads"].append("tiny-new-cell")
    with open(spec_path, "w") as f:
        json.dump(s, f)

    out = subprocess.run([sys.executable, "-c", RUN.format(bench=bench, root=ROOT, seed=SEED)], cwd=tmp,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    result = got["result"]
    assert result["correct"] and result["failed"] == 0, result["compared"]
    assert set(result["metrics"]) == {"mfu.train", "host_ms.train"}, result["metrics"]
    assert result["metrics"]["mfu.train"]["value"] > 0
    # the reference ran the new model in the harness's blocks of rows
    assert got["rows"] == [REF_ROWS]
    after = _hashes(tmp)
    changed = [p for p, h in before.items() if after.get(p) != h]
    assert changed == [os.path.relpath(spec_path, tmp)], changed
