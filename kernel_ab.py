#!/usr/bin/env python3
"""Time the attention kernels of two checkouts of this repository in turns
on one NVIDIA GPU.

    python3 kernel_ab.py OTHER_CHECKOUT [ROUNDS]

Runs OTHER, this checkout, this checkout, OTHER (ROUNDS times, default 1),
each in a fresh process that builds that checkout's kernels and times, in
bf16 at B=12, H=12, D=64 with CUDA events (100 launches after 5 of warm-up):
K1-fwd, K1-fwd stats and K1-bwd at N=1568; K2-fwd, K2-fwd stats and K2-bwd
at (Nq, Nk) = (392, 1568) and (1568, 1568); K3-fwd and K3-bwd at N=1568.
K1-bwd's launches (rowdot or prepass, dq, dkdv) are split under
`torch.profiler` (20 launches). Prints the card's name and power limit, one
JSON line per process, and a last JSON line with each checkout's mean ms
per kernel. Two versions of a kernel are compared only within one such
call, on one card. OTHER is typically the parent commit unpacked with
`git archive` into a directory that `.gitignore` lists (`_archive/`).
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

S = D ** -0.5
out = {
    "K1-fwd": time_ms(lambda: attn.fused_attention_qkv(qkv, H, S)),
    "K1-fwd-stats": time_ms(lambda: attn.attention_qkv_fwd_stats(qkv, H, S)),
    "K1-bwd": time_ms(lambda: attn.attention_qkv_bwd(qkv, o, do, m, l, H, S)),
}
for Nq, Nk in ((392, 1568), (1568, 1568)):
    q = torch.from_numpy(rng.standard_normal((B, Nq, H * D), dtype=np.float32)).to("cuda", torch.bfloat16)
    kv = torch.from_numpy(rng.standard_normal((B, Nk, 2 * H * D), dtype=np.float32)).to("cuda", torch.bfloat16)
    dq_o = torch.from_numpy(rng.standard_normal((B, Nq, H * D), dtype=np.float32)).to("cuda", torch.bfloat16)
    o2, m2, l2 = attn.attention_q_kv_fwd_stats(q, kv, H, S)
    out[f"K2-fwd {Nq}x{Nk}"] = time_ms(lambda: attn.fused_attention_q_kv(q, kv, H, S))
    out[f"K2-fwd-stats {Nq}x{Nk}"] = time_ms(lambda: attn.attention_q_kv_fwd_stats(q, kv, H, S))
    out[f"K2-bwd {Nq}x{Nk}"] = time_ms(lambda: attn.attention_q_kv_bwd(q, kv, o2, dq_o, m2, l2, H, S))
    del q, kv, dq_o, o2, m2, l2
hq, hk, hv, hdo = (torch.from_numpy(rng.standard_normal((B, H, N, D), dtype=np.float32)).to("cuda", torch.bfloat16)
                   for _ in range(4))
ho = attn.fused_attention(hq, hk, hv, S)
out["K3-fwd"] = time_ms(lambda: attn.fused_attention(hq, hk, hv, S))
out["K3-bwd"] = time_ms(lambda: attn.attention_head_major_bwd(hq, hk, hv, ho, hdo, S))
# K1-bwd's launches, device ms per launch under torch.profiler
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(20):
        attn.attention_qkv_bwd(qkv, o, do, m, l, H, S)
    torch.cuda.synchronize()
for e in prof.key_averages():
    for part in ("rowdot", "prepass", "dq_kernel", "dkdv_kernel"):
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
    print(json.dumps({label: {k: sum(t[k] for t in ts) / len(ts) for k in ts[0]}
                      for label, ts in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
