#!/usr/bin/env python3
"""Time the kernels of two checkouts of this repository in turns on one
NVIDIA GPU.

    python3 kernel_ab.py OTHER_CHECKOUT [ROUNDS]

Runs OTHER, this checkout, this checkout, OTHER (ROUNDS times, default 1),
each in a fresh process that builds that checkout's kernels and times, in
bf16 at B=12, H=12, D=64 with CUDA events (100 launches after 5 of warm-up):
K1-fwd, K1-fwd stats and K1-bwd at N=1568; K2-fwd, K2-fwd stats and K2-bwd
at (Nq, Nk) = (392, 1568) and (1568, 1568); K3-fwd and K3-bwd at N=1568;
K4 (`fused_slot_attention`) at the flagship agg round (12 x 2 slots,
D=768, 4 heads x 512, N=1568), warm (ctx left in L2 by the launch before;
1000 launches) and cold (a 64 MB write before each of 100 launches, CUDA
events around the launch alone); K5 (`patchify_embed`) at
[12, 16, 224, 224, 3] -> 768. K1-bwd's launches (rowdot or prepass, dq,
dkdv) and K4's are split under `torch.profiler` (20 calls). Prints the card's name and power limit, one
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
# K4 and K5
from devias_tpu_torch.kernels import patch_embed as pe
from devias_tpu_torch.kernels import slot_attention as sa
sa_in = [torch.from_numpy(rng.standard_normal(s[:-1], dtype=np.float32) * np.float32(s[-1])).to("cuda", torch.bfloat16)
         for s in ((B, 2, 768, 1.0), (B, N, 768, 1.0), (768, 2048, 0.02), (768, 2048, 0.02), (768, 2048, 0.02),
                   (2048, 768, 0.02), (768, 0.02))]
k4 = lambda: sa.fused_slot_attention(*sa_in, 4, 512)
with torch.no_grad():
    out["K4 warm"] = time_ms(k4, 1000, 20)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    cold = 0.0
    for _ in range(100):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        k4()
        end.record()
        end.synchronize()
        cold += start.elapsed_time(end)
    out["K4 cold"] = cold / 100
    del flush
x5 = torch.from_numpy(rng.standard_normal((B, 16, 224, 224, 3), dtype=np.float32)).cuda()
w5 = torch.from_numpy(rng.standard_normal((1536, 768), dtype=np.float32) * np.float32(1536 ** -0.5)).to(
    "cuda", torch.bfloat16)
out["K5"] = time_ms(lambda: pe.patchify_embed(x5, w5), 100)
# K1-bwd's and K4's launches, device ms per launch under torch.profiler
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(20):
        attn.attention_qkv_bwd(qkv, o, do, m, l, H, S)
    torch.cuda.synchronize()
for e in prof.key_averages():
    for part in ("rowdot", "prepass", "dq_kernel", "dkdv_kernel"):
        if part in e.key and e.device_time_total > 0:
            out["K1-bwd " + part] = e.device_time_total / e.count / 1e3
with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(20):
        k4()
    torch.cuda.synchronize()
for e in prof.key_averages():
    if e.key.startswith("k4::") and e.device_time_total > 0:
        out["K4 " + e.key[4:].split("(")[0]] = e.device_time_total / e.count / 1e3
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
    print(json.dumps({label: {k: sum(t[k] for t in ts) / len(ts) for k in ts[0] if all(k in t for t in ts)}
                      for label, ts in runs.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
