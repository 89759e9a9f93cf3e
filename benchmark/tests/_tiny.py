"""A tiny copy of the benchmark in a temporary directory: every file of
the benchmark but its tests and caches, and every cell of the real
`BENCHMARK.json` with its configuration cut to CPU size (64 wide, 2
blocks, 4 x 32 x 32 clips, float32 compute, the plain attention) and
batches of 4; the real traffic fields, limits, entries, models and metric
readers otherwise."""

from __future__ import annotations

import json
import os
import shutil

from harness.spec import BENCH_DIR, ROOT

TINY = dict(embed_dim=64, depth=2, num_heads=1, num_frames=4, img_size=32, fused_attention=False, dtype="float32")


def tiny_config(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    for key in ("model", "teacher"):
        if cfg.get(key):
            cfg[key].update(TINY)
    cfg["model"].update(num_classes=5, num_scene_classes=4)
    if cfg.get("teacher"):
        cfg["teacher"]["num_classes"] = 4
    return cfg


def tiny_bench(tmp: str) -> tuple:
    """(spec path, bench dir) of the tiny copy under `tmp`."""
    bench = os.path.join(tmp, "benchmark")
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests", "configs"))
    os.makedirs(os.path.join(bench, "configs"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = tiny_config(json.load(f))
        with open(os.path.join(tmp, c["file"]), "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(bench, "traffic")):
        path = os.path.join(bench, "traffic", name)
        with open(path) as f:
            traffic = json.load(f)
        traffic["batch"] = 4
        with open(path, "w") as f:
            json.dump(traffic, f)
    spec_path = os.path.join(tmp, "BENCHMARK.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    return spec_path, bench
