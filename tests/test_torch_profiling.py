"""The port's profiling utilities (`devias_tpu_torch/utils/profiling.py`)
and its dry run (`devias_tpu_torch/dryrun.py`) on the CPU:

- `profile_trace` writes a Chrome trace of a CPU block, and nothing with
  an empty directory;
- `python -m devias_tpu_torch.dryrun 2 --device cpu` (the tiny models over
  two gloo processes) exits 0 within 40 s and prints every mode line;
- `scripts/profile_step.py`'s family table classifies the port's kernel
  names as `chip_smoke.py`'s table did before it moved there, and its
  aggregation of a small Chrome trace gives family sums equal to the
  device total, the top kernels' launches per step, the tail grouped
  by name prefix, and the device time by family under the innermost
  program span whose host range holds each launch."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
MODE_LINES = ("dp loss=", "dp zero1 loss=", "dp fsdp loss=", "dp x tp loss=", "dp x sp loss=",
              "dp x sp stochastic loss=", "dp x pp FULL slot step loss=", "tiny-geometry fsdp resident")


def test_profile_trace_writes_a_trace(tmp_path):
    from devias_tpu_torch.utils import profile_trace

    with profile_trace(str(tmp_path / "trace"), device="cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profile_trace("", device="cpu"):
        pass
    assert os.listdir(tmp_path) == ["trace"]


def test_dryrun_prints_every_mode():
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "devias_tpu_torch.dryrun", "2", "--device", "cpu"], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True, text=True, timeout=120)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("entry ok: [(1, 765), (1, 765)]")
    for mode in MODE_LINES:
        hits = [ln for ln in lines if ln.startswith(f"dryrun_multichip(2): {mode}")]
        assert len(hits) == 1 and hits[0].endswith(" ok"), (mode, proc.stdout)
    assert seconds < 40, seconds


@pytest.mark.parametrize("name,family", [
    ("attention_fwd_kernel<1, true>", "attention (port's K1 and K2 kernels)"),
    ("attention_bwd_dq_kernel", "attention (port's K1 and K2 kernels)"),
    ("attention_bwd_dkdv_kernel", "attention (port's K1 and K2 kernels)"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "GEMM (cuBLAS)"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "GEMM (cuBLAS)"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("Memset (Device)", "copy"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>", "copy"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>>", "elementwise"),
    ("patch_embed_kernel", "other"),
])
def test_kernel_families_are_chip_smokes(name, family):
    from devias_tpu_torch.scripts.profile_step import kernel_class

    assert kernel_class(name) == family


def _kernel(name, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "dur": dur, "ts": 0, "pid": 0, "tid": 7}


def test_aggregate_reads_a_chrome_trace(tmp_path, capsys):
    from devias_tpu_torch.scripts.profile_step import KERNEL_CLASSES, aggregate

    steps = 2
    ew = "void at::native::vectorized_elementwise_kernel<4, at::native::{}<float>>(int, float*)"
    events = ([_kernel("attention_fwd_kernel", 300.0)] * 4 + [_kernel("nvjet_tst_64x8_v", 150.0)] * 6
              + [_kernel("Memcpy HtoD (Pageable -> Device)", 40.0, "gpu_memcpy")] * 2
              + [_kernel(ew.format("AddFunctor"), 5.0), _kernel(ew.format("MulFunctor"), 7.0)]
              + [_kernel(ew.format("FillFunctor"), 3.0)] * 2
              + [_kernel("(anonymous namespace)::attention_bwd_prepass_kernel(k1::Strided<float const>, int)", 1.0),
                 _kernel("nvjet_tst_128x160_64x5_2x4_h_bz_NTT", 2.0), _kernel("nvjet_tst_64x8_64x16_4x1_v_bz", 3.0)]
              # host work and annotations are not the card's
              + [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 999.0},
                 {"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step#FusedAdamW", "dur": 999.0},
                 {"ph": "M", "name": "process_name", "args": {"name": "python"}}])
    os.makedirs(tmp_path / "older")
    with open(tmp_path / "older" / "trace.json", "w") as f:
        json.dump({"traceEvents": events[:1]}, f)
    os.utime(tmp_path / "older" / "trace.json", (0, 0))
    with open(tmp_path / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)

    report = aggregate(str(tmp_path), steps, top=3)
    total = (4 * 300 + 6 * 150 + 2 * 40 + 5 + 7 + 2 * 3 + 1 + 2 + 3) / 1000 / steps
    assert report["trace"] == str(tmp_path / "trace.json")
    assert report["device_ms_per_step"] == pytest.approx(total)
    assert sum(report["ms_per_step_by_family"].values()) == pytest.approx(total)
    assert set(report["ms_per_step_by_family"]) <= {label for label, _ in KERNEL_CLASSES} | {"other"}
    assert report["ms_per_step_by_family"]["GEMM (cuBLAS)"] == pytest.approx((6 * 150 + 2 + 3) / 1000 / steps)
    assert [(t["name"], t["launches"]) for t in report["top"]] == [
        ("attention_fwd_kernel", 2.0), ("nvjet_tst_64x8_v", 3.0), ("Memcpy HtoD (Pageable -> Device)", 1.0)]
    assert report["tail"] == [
        {"prefix": "at::native::vectorized_elementwise_kernel", "ms": pytest.approx(0.009), "launches": 2.0},
        {"prefix": "nvjet_tst", "ms": pytest.approx(0.0025), "launches": 1.0},
        {"prefix": "attention_bwd_prepass_kernel", "ms": pytest.approx(0.0005), "launches": 0.5}]
    assert report["tail_ms_per_step"] == pytest.approx(0.012)
    assert "device total: 1.10 ms/step over 2 steps" in capsys.readouterr().out


def _event(name, ts, dur, cat, correlation=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def test_aggregate_splits_device_time_by_program_span(tmp_path):
    from devias_tpu_torch.scripts.profile_step import NO_SPAN, aggregate

    ew = "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>(int, float*)"
    host = [
        # one step on the host: the step's span holds FAME's, the student's
        # and the backward's, the student's holds the agg block's; the
        # optimizer's own annotation is not a program span
        _event("train.step", 0.0, 1000.0, "user_annotation"), _event("train.fame", 0.0, 100.0, "user_annotation"),
        _event("train.student", 200.0, 500.0, "user_annotation"), _event("nn.agg", 600.0, 100.0, "user_annotation"),
        _event("train.backward", 700.0, 200.0, "user_annotation"),
        _event("Optimizer.step#FusedAdamW.step", 900.0, 50.0, "user_annotation"),
        # the card's annotation ranges are not read
        _event("train.loss", 0.0, 2000.0, "gpu_user_annotation"),
    ]
    # (launch time, launch category, kernel, its duration, category on the card)
    work = [(10.0, "cuda_runtime", ew, 40.0, "kernel"), (50.0, "cuda_runtime", ew, 20.0, "kernel"),
            (250.0, "cuda_runtime", "nvjet_tst_64x8_v", 300.0, "kernel"),
            (650.0, "cuda_runtime", ew, 10.0, "kernel"),
            (660.0, "cuda_driver", "attention_fwd_kernel", 50.0, "kernel"),
            (150.0, "cuda_runtime", ew, 30.0, "kernel"),
            # the backward's, launched from autograd's thread while the
            # step's thread waits inside its span
            (750.0, "cuda_driver", "attention_bwd_dq_kernel", 100.0, "kernel"),
            (920.0, "cuda_runtime", ew, 20.0, "kernel"),
            (1100.0, "cuda_runtime", "Memcpy HtoD (Pinned -> Device)", 80.0, "gpu_memcpy")]
    events = list(host)
    for k, (at, launch_cat, name, dur, cat) in enumerate(work):
        events.append(dict(_event("cudaLaunchKernel", at, 5.0, launch_cat, k), tid=8 if k == 6 else 7))
        events.append(_event(name, 2000.0 + 100 * k, dur, cat, k))
    # a kernel whose launch the trace lacks
    events.append(_event(ew, 5000.0, 6.0, "kernel", 99))
    with open(tmp_path / "trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    by_span = aggregate(str(tmp_path), 2, top=3)["ms_per_step_by_span"]
    assert by_span == {
        "train.fame": {"elementwise": pytest.approx(0.03)},
        "train.student": {"GEMM (cuBLAS)": pytest.approx(0.15)},
        "nn.agg": {"elementwise": pytest.approx(0.005), "attention (port's K1 and K2 kernels)": pytest.approx(0.025)},
        "train.backward": {"attention (port's K1 and K2 kernels)": pytest.approx(0.05)},
        "train.step": {"elementwise": pytest.approx(0.025)},
        NO_SPAN: {"copy": pytest.approx(0.04), "elementwise": pytest.approx(0.003)},
    }
