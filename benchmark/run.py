#!/usr/bin/env python3
"""The benchmark of devias_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the repository's root. One run: build the cell's configuration
with weights from the seed, make its inputs on the card from the seed, run
the checked and warm-up steps (set-up), measure for `--seconds`, with
`--trace 1` profile a few more calls, free the program, judge what the
timed path produced against the plain reference, and print the result as
the last line of standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`compared`, each compared number with its limit (also the last lines of
standard error). Without a card it exits 3 and prints no result; when a
JAX module is loaded after the window, it fails and prints none.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# every build and kernel cache at a fixed place inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "nv"}
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "devias_tpu")


def set_caches(bench_dir: str = BENCH_DIR) -> None:
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(bench_dir, ".cache", sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a JAX package or the JAX
    port's reference package, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description="benchmark one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float = None) -> dict:
    """One run of `cell` on `device`: the result line's object, or an
    exception. `t_start` is when the process began (set-up counts from
    it)."""
    import torch

    from harness import report, spec

    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    entry = spec.entry(cell.traffic["entry"]).make(cell.config, cell.traffic, seed, device)
    try:
        entry.setup()
        rec = entry.window(seconds)
        rec["setup_s"] = rec["window_start"] - t_start
        prof = entry.profile(cell.traffic["profile_units"]) if trace else None
        if forbidden_modules():
            raise RuntimeError(f"loaded after the window: {forbidden_modules()}")
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1,
               "memory_peak_bytes": rec["peak_bytes"]}
        if trace:
            dev.update(busy_s=prof["busy_s"], window_s=prof["wall_s"])
            metrics = spec.read_per_layer(cell, {"record": rec, "profile": prof, "config": cell.config,
                                                 "traffic": cell.traffic})
        else:
            metrics = report.end_to_end(cell.end_to_end, rec, strict=cuda)
        entry.release()
        verdict = entry.check(cell.limits)
    finally:
        getattr(entry, "close", lambda: None)()
    compared = verdict["compared"]
    attempted = rec.get("steps", rec["clips"])
    failed = int(compared["missing"]["value"]) if "missing" in compared else (0 if rec["finite"] else attempted)
    result = {"correct": verdict["correct"] and rec["finite"], "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    args = parse(argv)
    set_caches()
    for path in (ROOT, BENCH_DIR):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from harness import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    if forbidden_modules():
        print(f"run.py: loaded: {forbidden_modules()}", file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
