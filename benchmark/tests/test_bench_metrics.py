"""The metric arithmetic against hand-worked values."""

from __future__ import annotations

import json
import os

import pytest

from harness import roofline, spec
from harness.report import END_TO_END, p95
from harness.spec import ROOT

K400 = json.load(open(os.path.join(ROOT, "benchmark/configs/devias-slot-vitb16-k400.json")))
HVU = json.load(open(os.path.join(ROOT, "benchmark/configs/devias-slot-vitb16-hvu.json")))


def test_p95_is_the_nearest_rank():
    # 200 steps: the 190th smallest, with ten steps beyond it
    assert p95([float(v) for v in range(200, 0, -1)]) == 190.0
    assert p95([5.0]) == 5.0
    assert END_TO_END["step_ms_p95"]({"step_ms": [float(v) for v in range(1, 21)]}) == 19.0


def test_model_flops_per_clip():
    # one ViT-B block at N tokens: 24 N C^2 (qkv, proj, MLP) + 4 N^2 C
    # (the two attention products); 12 blocks
    student = 12 * (24 * 1568 * 768 ** 2 + 4 * 1568 ** 2 * 768)
    teacher = 12 * (24 * 1569 * 768 ** 2 + 4 * 1569 ** 2 * 768)
    assert student == 356989796352 and teacher == 357275308032
    assert roofline.flops_per_clip(K400, train=True) == 3 * student + teacher  # 1.428 TFLOP
    assert roofline.flops_per_clip(K400, train=False) == student + teacher
    assert roofline.flops_per_clip(HVU, train=True) == 3 * student


def test_mfu_train():
    # 120 steps of 12 clips in 18 s: 17.1389 TFLOP a step at 6.667 steps/s
    rec = {"kind": "train", "clips": 1440, "wall_s": 18.0, "flops_per_clip": 1428244697088}
    got = spec.reader("mfu.train")({"record": rec})
    assert got == pytest.approx(1428244697088 * 1440 / 18.0 / 989e12 * 100)
    assert got == pytest.approx(11.5529, abs=1e-3)
    assert spec.reader("mfu.eval")({"record": rec}) is None


def test_attention_bounds():
    # forward at N = 1568: 4 B H N^2 D = 90.64 GFLOP over 989 TFLOP/s
    assert roofline.attention_bound_ms(12, 12, 1568, 64) == pytest.approx(0.0916428, rel=1e-5)
    assert roofline.attention_bound_ms(12, 12, 1569, 64) == pytest.approx(0.0917597, rel=1e-5)
    # backward: 10 B H N^2 D
    assert roofline.attention_bwd_bound_ms(12, 12, 1568, 64) == pytest.approx(0.2291070, rel=1e-5)
    # bytes bind at a short sequence: N = 16 moves 4 B N H D bf16 (+ m, l)
    assert roofline.attention_bound_ms(1, 1, 16, 64) == pytest.approx(4 * 16 * 64 * 2 / 3.35e12 * 1e3)


def _profiled(kind, launches, attention_ms, batch=12):
    return {"record": {"kind": kind}, "config": K400, "traffic": {"batch": batch},
            "profile": {"launches_per_unit": launches, "busy_s": 0.9, "wall_s": 1.2,
                        "device_ms_by_class": {"attention (port's K1 and K2 kernels)": attention_ms,
                                               "elementwise": 42.0, "GEMM (cuBLAS)": 21.0}}}


def test_attention_roofline_train():
    # a K400 step: the teacher's 12 no-stats forwards at N = 1569, the
    # student's 12 stats forwards and 12 backwards at 1568, in 17.2 ms
    run = _profiled("train", {"K1-fwd": 12, "K1-fwd-stats": 12, "K1-bwd": 12}, 17.2)
    bound = 12 * 0.0917597 + 12 * 0.0916428 + 12 * 0.2291070  # 4.950 ms
    assert spec.reader("attn_roofline.train")(run) == pytest.approx(bound / 17.2 * 100, rel=1e-4)
    assert spec.reader("attn_roofline.train")(run) == pytest.approx(28.78, abs=0.01)
    # no K1 time: nothing to read
    assert spec.reader("attn_roofline.train")(_profiled("train", {"K1-fwd": 0}, 0.0)) is None


def test_attention_roofline_eval():
    # a final_test batch: 12 student forwards at 1568, 12 teacher ones at 1569
    run = _profiled("eval", {"K1-fwd": 24, "K1-fwd-stats": 0, "K1-bwd": 0}, 7.5)
    assert spec.reader("attn_roofline.eval")(run) == pytest.approx(
        (12 * 0.0916428 + 12 * 0.0917597) / 7.5 * 100, rel=1e-4)


def test_class_and_idle_readers():
    run = _profiled("train", {}, 17.2)
    assert spec.reader("elementwise_ms.train")(run) == 42.0
    assert spec.reader("gemm_ms.train")(run) == 21.0
    assert spec.reader("idle_share.train")(run) == pytest.approx(25.0)
    assert spec.reader("idle_share.eval")(run) is None


def test_host_ms_readers():
    train = {"record": {"kind": "train", "host_ms": [100.0, 110.0, 120.0]}}
    assert spec.reader("host_ms.train")(train) == pytest.approx(110.0)
    evaluation = {"record": {"kind": "eval", "host_ms": [3.0, 5.0, 4.0, 4.0], "batches": 2}}
    assert spec.reader("host_ms.eval")(evaluation) == pytest.approx(8.0)
