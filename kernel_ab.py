#!/usr/bin/env python3
"""Time the K1 attention kernels of two checkouts of this repository in
turns on one NVIDIA GPU.

    python3 kernel_ab.py OTHER_CHECKOUT [ROUNDS]

Runs OTHER, this checkout, this checkout, OTHER (ROUNDS times, default 1),
each in a fresh process that builds that checkout's kernels and times
K1-fwd, K1-fwd stats and K1-bwd at B=12, H=12, N=1568, D=64 in bf16 with
CUDA events (100 launches after 5 of warm-up), and K1-bwd's three kernels
(rowdot, dq, dkdv) under `torch.profiler` (20 launches). Prints the card's name and
power limit, one JSON line per process, and a last JSON line with each
checkout's mean ms per kernel. Two versions of a kernel are compared only
within one such call, on one card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_CHILD = r"""
import json, sys
import numpy as np
import torch
from devias_tpu_torch.kernels import _build
from devias_tpu_torch.kernels import attention as attn
_build.build_all()
B, H, N, D = 12, 12, 1568, 64
rng = np.random.default_rng(0)
qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * D), dtype=np.float32)).to("cuda", torch.bfloat16)
do = torch.from_numpy(rng.standard_normal((B, N, H * D), dtype=np.float32)).to("cuda", torch.bfloat16)
o, m, l = attn.attention_qkv_fwd_stats(qkv, H, D ** -0.5)

def time_ms(fn, iters=100, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters

out = {
    "K1-fwd": time_ms(lambda: attn.fused_attention_qkv(qkv, H, D ** -0.5)),
    "K1-fwd-stats": time_ms(lambda: attn.attention_qkv_fwd_stats(qkv, H, D ** -0.5)),
    "K1-bwd": time_ms(lambda: attn.attention_qkv_bwd(qkv, o, do, m, l, H, D ** -0.5)),
}
# K1-bwd's three kernels, device ms per launch under torch.profiler
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(20):
        attn.attention_qkv_bwd(qkv, o, do, m, l, H, D ** -0.5)
    torch.cuda.synchronize()
for e in prof.key_averages():
    for part in ("rowdot", "dq_kernel", "dkdv_kernel"):
        if part in e.key and e.device_time_total > 0:
            out["K1-bwd " + part] = e.device_time_total / e.count / 1e3
print(json.dumps(out))
"""


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    here = os.path.dirname(os.path.abspath(__file__))
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed", flush=True)
    runs = {"other": [], "this": []}
    for _ in range(rounds):
        for label, root in (("other", other), ("this", here), ("this", here), ("other", other)):
            out = subprocess.run([sys.executable, "-c", _CHILD], cwd=root, capture_output=True, text=True,
                                 timeout=600, env=dict(os.environ, PYTHONPATH=root))
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
                return 1
            times = json.loads(out.stdout.strip().splitlines()[-1])
            runs[label].append(times)
            print(json.dumps({"checkout": label, "root": root, **times}), flush=True)
    print(json.dumps({label: {k: sum(t.get(k, 0.0) for t in ts) / len(ts) for k in ts[0]}
                      for label, ts in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
