"""The port's spans and counter (`devias_tpu_torch/utils/profiling.py`) on
the CPU:

- with no profiler running a span or a count records nothing, and costs a
  small part of a `record_function`;
- under `torch.profiler` a tiny slot train step and a tiny HVU step record
  each `train.*` span and `nn.agg` once a step (`train.teacher` in the slot
  step only), and a tiny `final_test` records `eval.forward` twice and
  `eval.fetch` once a batch;
- a span's self time is its total less its children's;
- the tally starts again with a new profiled stretch;
- the spans are the profiler's CPU user annotations;
- `h2d_bytes` stays 0 when nothing crosses to a card, and counts the bytes
  of each host array sent to one (marked `cuda`);
- a tiny slot step with the Segformer mix enters `train.mask_model` inside
  `train.fame` once a step and counts B T/2 `mask_frames`; a device span
  reads None off the card, and counts made while a graph is captured go
  to the capture's own tally."""

import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from devias_tpu_torch.aug import FAMEConfig
from devias_tpu_torch.eval.protocols import final_test
from devias_tpu_torch.losses import SlotLossConfig
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import (OptimConfig, TrainState, TrainStepConfig, make_eval_step, make_hvu_train_step,
                                    make_optimizer, make_slot_train_step)
from devias_tpu_torch.train.step import to_device
from devias_tpu_torch.nn.segformer import create_segformer
from devias_tpu_torch.utils import count, counter_totals, device_span, device_span_ms, span, span_totals
from devias_tpu_torch.utils.profiling import captured_counts

from _segformer_weights import TINY as TINY_SEGFORMER

SMALL = dict(depth=2, embed_dim=64, num_heads=4)
SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=8, img_size=32, **SMALL)
TEACHER = dict(num_classes=4, use_mean_pooling=False, img_size=32, **SMALL)
TRAIN_SPANS = ("train.step", "train.fame", "train.student", "nn.agg", "train.loss", "train.backward",
               "train.optimizer")


def _profiled(fn):
    """fn() under a CPU profiler, in a stretch of its own: a span made
    without the profiler first, so the tally starts again."""
    with span("unprofiled"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _clips(B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, 4, 32, 32, 3)).astype(np.float32)


def test_a_span_without_a_profiler_records_nothing():
    _profiled(lambda: count("h2d_bytes", 0))
    before = (span_totals(), counter_totals())
    with span("train.step"):
        with span("nn.agg"):
            count("h2d_bytes", 7)
    assert (span_totals(), counter_totals()) == before


def test_a_span_without_a_profiler_costs_a_small_part_of_a_record_function():
    def spanned():
        with span("train.step"):
            pass

    def ranged():
        with torch.autograd.profiler.record_function("train.step"):
            pass

    n = 20000
    ours = min(timeit.repeat(spanned, number=n, repeat=5)) / n
    theirs = min(timeit.repeat(ranged, number=n, repeat=5)) / n
    assert ours < 0.5 * theirs, (ours, theirs)


def _steps(kind):
    """Two steps of a tiny slot (with its teacher) or HVU step, FAME on."""
    model = create_model("slot_vit_base_patch16_224", device="cpu", seed=0, **SLOT)
    opt, lr_fn = make_optimizer(model, OptimConfig(lr=1e-3, total_steps=8, warmup_steps=2), device="cpu")
    state = TrainState.create(model, opt, device="cpu")
    step_cfg = TrainStepConfig(fame=FAMEConfig(beta=0.5, prob_aug=0.8))
    batch = {"videos": _clips(2), "labels": np.array([1, 3])}
    if kind == "slot":
        teacher = create_model("vit_base_patch16_224", device="cpu", seed=1, **TEACHER)
        step = make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4), step_cfg, lr_fn, device="cpu")
    else:
        batch["scene_labels"] = np.array([0, 2])
        step = make_hvu_train_step(model, opt, SlotLossConfig(5, 4), step_cfg, lr_fn, device="cpu")
    gen = torch.Generator().manual_seed(0)
    return lambda: [step(state, batch, generator=gen) for _ in range(2)]


@pytest.mark.parametrize("kind", ["slot", "hvu"])
def test_a_train_step_records_each_phase_once_a_step(kind):
    _profiled(_steps(kind))
    calls = {k: v["calls"] for k, v in span_totals().items()}
    want = dict.fromkeys(TRAIN_SPANS + (("train.teacher",) if kind == "slot" else ()), 2)
    assert calls == want
    assert counter_totals().get("h2d_bytes", 0) == 0


def test_final_test_records_two_forwards_and_one_fetch_a_batch(tmp_path):
    model = create_model("slot_vit_base_patch16_224", device="cpu", seed=0, **SLOT)
    teacher = create_model("vit_base_patch16_224", device="cpu", seed=1, **TEACHER)
    scene, label = make_eval_step(model, "scene_logit", "cpu"), make_eval_step(teacher, "logits", "cpu")
    zeros = np.zeros(2, np.int64)
    batches = [{"videos": _clips(2, i), "video_id": [f"{i}_0", f"{i}_1"], "chunk": zeros, "split": zeros}
               for i in range(3)]
    _profiled(lambda: final_test(batches, scene, 2, str(tmp_path), scene_label_fn=label, device="cpu"))
    calls = {k: v["calls"] for k, v in span_totals().items()}
    assert calls == {"eval.forward": 6, "nn.agg": 3, "eval.fetch": 3}
    assert counter_totals().get("h2d_bytes", 0) == 0


def test_self_time_is_the_total_less_the_children():
    def nest():
        with span("outer"):
            torch.ones(256, 256) @ torch.ones(256, 256)
            for _ in range(2):
                with span("inner"):
                    with span("leaf"):
                        torch.ones(128, 128) @ torch.ones(128, 128)

    _profiled(nest)
    t = span_totals()
    assert {k: v["calls"] for k, v in t.items()} == {"outer": 1, "inner": 2, "leaf": 2}
    assert t["outer"]["self_ns"] == t["outer"]["total_ns"] - t["inner"]["total_ns"]
    assert t["inner"]["self_ns"] == t["inner"]["total_ns"] - t["leaf"]["total_ns"]
    assert t["leaf"]["self_ns"] == t["leaf"]["total_ns"] > 0
    assert t["outer"]["self_ns"] > 0 and t["inner"]["self_ns"] >= 0


def test_the_tally_starts_again_with_a_new_profiled_stretch():
    def mark(name, n):
        with span(name):
            count("rows", n)

    _profiled(lambda: mark("a", 2))
    assert set(span_totals()) == {"a"} and counter_totals() == {"rows": 2}
    # a second profiler with nothing recorded between: the same stretch
    with profile(activities=[ProfilerActivity.CPU]):
        mark("a", 3)
    assert span_totals()["a"]["calls"] == 2 and counter_totals() == {"rows": 5}
    # a span made without a profiler ends the stretch
    _profiled(lambda: mark("b", 4))
    assert set(span_totals()) == {"b"} and counter_totals() == {"rows": 4}


def test_spans_are_the_profilers_cpu_user_annotations():
    def nest():
        with span("train.step"):
            with span("train.loss"):
                torch.ones(8) + 1

    prof = _profiled(nest)
    marked = [e for e in prof.events() if e.name in ("train.step", "train.loss")]
    assert sorted(e.name for e in marked) == ["train.loss", "train.step"]
    assert all(e.is_user_annotation and e.device_type == torch.autograd.DeviceType.CPU for e in marked)
    step, loss = sorted(marked, key=lambda e: e.name != "train.step")
    assert step.time_range.start <= loss.time_range.start and loss.time_range.end <= step.time_range.end


def test_h2d_bytes_stays_zero_off_the_card():
    prof = _profiled(lambda: (to_device(_clips(2), torch.device("cpu")),
                              to_device(torch.ones(3), torch.device("cpu"))))
    assert counter_totals().get("h2d_bytes", 0) == 0 and "h2d.stage" not in span_totals()
    assert not [e for e in prof.events() if e.name == "h2d.stage"]


@pytest.mark.cuda
def test_h2d_bytes_counts_each_host_array_sent_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda")
    clips = _clips(3)
    with span("unprofiled"):
        pass
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on_card = [to_device(clips, card) for _ in range(2)]
        to_device(on_card[0], card)  # already there: nothing crosses
        torch.cuda.synchronize()
    assert counter_totals() == {"h2d_bytes": 2 * clips.nbytes}
    assert span_totals()["h2d.stage"]["calls"] == 2
    assert torch.equal(on_card[1].cpu(), torch.from_numpy(clips))


def _segformer_steps(B=2):
    """Two steps of a tiny slot step with the Segformer mix in FAME's
    place (the port's tiny Segformer, float32)."""
    model = create_model("slot_vit_base_patch16_224", device="cpu", seed=0, **SLOT)
    teacher = create_model("vit_base_patch16_224", device="cpu", seed=1, **TEACHER)
    opt, lr_fn = make_optimizer(model, OptimConfig(lr=1e-3, total_steps=8, warmup_steps=2), device="cpu")
    state = TrainState.create(model, opt, device="cpu")
    step_cfg = TrainStepConfig(use_fame=False, fame=FAMEConfig(beta=0.5, prob_aug=0.8))
    step = make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4), step_cfg, lr_fn,
                                segformer_apply=create_segformer(TINY_SEGFORMER, device="cpu"), device="cpu")
    batch = {"videos": _clips(B), "labels": np.arange(B) % 5}
    gen = torch.Generator().manual_seed(0)
    return lambda: [step(state, batch, generator=gen) for _ in range(2)]


def test_a_segformer_step_records_its_mask_model_and_counts_its_frames():
    _profiled(_segformer_steps(B=3))
    t = span_totals()
    calls = {k: v["calls"] for k, v in t.items()}
    assert calls == dict.fromkeys(TRAIN_SPANS + ("train.teacher", "train.mask_model"), 2)
    # 3 clips of 4 frames: 6 masked frames a step
    assert counter_totals() == {"mask_frames": 2 * 6}
    # the mask model is a child of the mix
    assert t["train.mask_model"]["total_ns"] <= t["train.fame"]["total_ns"] - t["train.fame"]["self_ns"]


def test_a_device_span_reads_nothing_off_the_card():
    with profile(activities=[ProfilerActivity.CPU]):
        with device_span("test.block", torch.device("cpu")):
            torch.ones(8) + 1
    assert device_span_ms("test.block") is None
    assert device_span_ms("never.entered") is None


def test_counts_made_in_a_capture_go_to_its_own_tally():
    _profiled(lambda: count("rows", 1))
    before = counter_totals()
    with captured_counts() as counted:
        count("mask_frames", 8)
        with profile(activities=[ProfilerActivity.CPU]):
            count("mask_frames", 8)
    assert counted == {"mask_frames": 16} and counter_totals() == before
    # outside the block, counts go to the tally again
    with profile(activities=[ProfilerActivity.CPU]):
        count("rows", 2)
    assert counter_totals() == {"rows": 3}
