"""The SegFormer-B3 mask model's cell on the CPU: the plain reference
against the port's `Segformer` at the B3 geometry, the reference mix
against the port's, the model file's operations and parameters, and the
entry on a tiny copy of the benchmark (the mask model at the port's tiny
test geometry, float32), traced and correct, with its planted faults and a
broken port (the mix skipped, the state left unchanged) turning `correct`
false."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

import devias_tpu_torch.train.step as train_step
from devias_tpu_torch.train.optim import FusedAdamW
from harness import entries, spec
from harness.spec import BENCH_DIR, ROOT
from run import run_cell

from _tiny import tiny_bench

SEED = 2 ** 31 + 83
CELL = "slot-k400-segformer-train"
CONFIG = "devias-slot-vitb16-k400-segformer-b3"
# the port's tiny Segformer test geometry (`tests/_segformer_weights.py`)
TINY_MASK = dict(hidden_sizes=[16, 32, 80, 128], depths=[1, 1, 2, 1], decoder_hidden_size=64, dtype="float32")


def _config():
    with open(os.path.join(ROOT, "benchmark", "configs", f"{CONFIG}.json")) as f:
        return json.load(f)


def _entry_module():
    return spec.entry("slot_segformer_train")


def test_the_reference_is_the_ports_segformer_at_b3():
    """Float32, the same seeded weights, two 64 x 64 frames: the logits
    agree to rounding (HF's concat-then-fuse against the port's
    fuse-then-upsample order), and the parameter and buffer names are the
    same set."""
    m = dict(_config()["mask_model"], dtype="float32")
    model = spec.model(m["name"])
    port, ref = model.program(m, "cpu"), model.reference(m)
    assert set(port.state_dict()) == set(ref.state_dict())
    weights = _entry_module().mask_weights(m, SEED, "cpu")
    for net in (port, ref):
        net.load_state_dict(weights, strict=False)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = port(x), ref(x)
    assert got.shape == want.shape == (2, 16, 16, 19)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.std()), float((got - want).abs().max())


@pytest.mark.parametrize("keep", [(True, True, False), (False, True, True)])
def test_the_reference_mix_is_bitwise_the_ports(keep):
    from devias_tpu_torch.aug import segformer_mix_sample
    from reference.segformer_train import mix

    g = torch.Generator().manual_seed(1)
    videos = torch.randn(3, 4, 32, 32, 3, generator=g)
    masks = (torch.rand(3, 2, 32, 32, generator=g) < 0.3).float()
    draws = {"perm": torch.tensor([2, 0, 1]), "keep": torch.tensor(keep), "frame": torch.tensor(1)}
    labels = torch.arange(3)
    got_v, got_l, (got_fg, got_pf) = segformer_mix_sample(masks, videos, labels, draws=draws)
    want_v, want_fg, want_pf = mix(videos, masks, draws["perm"], draws["keep"], draws["frame"])
    assert torch.equal(got_v, want_v) and torch.equal(got_fg, want_fg) and torch.equal(got_pf, want_pf)
    assert torch.equal(got_l, labels)


def test_the_operations_and_parameters_of_b3():
    cfg = _config()
    m, mm = cfg["model"], cfg["mask_model"]
    model = spec.model(mm["name"])
    assert round(model.flops_per_frame(mm) / 1e9, 2) == 17.88
    assert model.flops_per_clip(mm) == 8 * model.flops_per_frame(mm)
    assert round(model.parameters(mm) / 1e6, 2) == 47.24
    assert model.tokens(mm) == 3136
    assert 1.70 < model.bound_ms(mm, 96, m["img_size"]) < 1.78
    # the model operations a window counts per clip: k400's and the mask model's
    total = entries.roofline.flops_per_clip(cfg, train=True) + model.flops_per_clip(mm, 8, 224)
    assert round(total / 1e9, 1) == 1571.3


def test_the_tie_margin_is_twice_the_logit_limit():
    with open(os.path.join(BENCH_DIR, "limits", f"{CELL}.json")) as f:
        limits = json.load(f)
    assert _entry_module().TIE_SIGMAS == pytest.approx(2 * limits["mask_logit_gap"])
    assert limits["mask_tie_share"] is None and limits["mask_gap"] is not None


def test_the_references_import_no_program_and_no_jax():
    code = f"""
import sys
sys.path[:0] = [{ROOT!r}, {BENCH_DIR!r}]
import reference.segformer, reference.segformer_train
print(sorted({{n.split('.')[0] for n in sys.modules}} & {{'jax', 'jaxlib', 'flax', 'devias_tpu', 'devias_tpu_torch'}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The tiny copy, its mask model at the tiny geometry in float32."""
    tmp = str(tmp_path_factory.mktemp("bench"))
    spec_path, bench_dir = tiny_bench(tmp)
    path = os.path.join(tmp, "benchmark", "configs", f"{CONFIG}.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["mask_model"].update(TINY_MASK)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return spec_path, bench_dir


def _cell(bench):
    return spec.load_cell(CELL, *bench)


def test_a_traced_run_is_correct_and_counts_the_masked_frames(bench):
    cell = _cell(bench)
    result = run_cell(cell, SEED, 0.3, True, "cpu")
    assert result["correct"] and result["failed"] == 0, result["compared"]
    assert set(result["compared"]) == {"loss1_gap", "grad_gap", "loss_gap", "change_gap", "mask_logit_gap",
                                       "mask_gap", "mask_tie_share"}
    got = result["metrics"]
    # B T/2 frames a step; off the card the device span reads nothing
    assert got["mask_frames.train"]["value"] == cell.traffic["batch"] * cell.config["model"]["num_frames"] // 2
    assert "mask_model_ms.train" not in got and "mask_model_roofline.train" not in got
    assert got["mfu.train"]["value"] > 0


def test_the_window_counts_the_mask_models_operations(bench):
    cell = _cell(bench)
    entry = spec.entry(cell.traffic["entry"]).make(cell.config, cell.traffic, SEED, "cpu")
    entry.setup()
    rec = entry.window(0.1)
    m, mm = cell.config["model"], cell.config["mask_model"]
    extra = spec.model(mm["name"]).flops_per_clip(mm, m["num_frames"] // 2, m["img_size"])
    assert rec["flops_per_clip"] == entries.roofline.flops_per_clip(cell.config, train=True) + extra


@pytest.fixture(scope="module")
def checked(bench):
    """A tiny entry after its checked steps, the program freed, and the
    sound reference."""
    cell = _cell(bench)
    entry = spec.entry(cell.traffic["entry"]).make(cell.config, cell.traffic, SEED, "cpu")
    entry.setup()
    entry.release()
    return cell, entry, entry.reference_readings()


def test_the_program_reads_near_the_reference(checked):
    _, entry, ref = checked
    train = entries.train_gaps(entry.readings, ref)
    mask = _entry_module().mask_gaps(entry.mask, ref["mask"])
    assert train["grad_gap"] < 1e-4 and train["change_gap"] < 1e-4, train
    assert mask["mask_logit_gap"] < 1e-4 and mask["mask_gap"] == 0, mask
    masks = torch.stack(entry.mask["masks"]).float()
    assert 0.05 < float(masks.mean()) < 0.95


@pytest.mark.parametrize("fault", ["odd_frames", "no_mask"])
def test_a_planted_fault_is_not_correct(checked, fault):
    cell, entry, ref = checked
    got = entry.reference_readings(fault=fault)
    numbers = {**entries.train_gaps(got, ref), **_entry_module().mask_gaps(got["mask"], ref["mask"])}
    verdict = entries.judge(numbers, cell.limits)
    assert not verdict["correct"], verdict["compared"]


def _skipped(masks, videos, labels, *args, **kw):
    B, T, H, W, _ = videos.shape
    n = (H // 16) * (W // 16)
    return videos, labels, (torch.zeros(B, n), torch.zeros(B, (T // 2) * n))


@pytest.mark.parametrize("fault", ["mix_skipped", "state_unchanged"])
def test_a_broken_port_is_not_correct(bench, monkeypatch, fault):
    if fault == "mix_skipped":
        monkeypatch.setattr(train_step, "segformer_mix_sample", _skipped)
    else:
        monkeypatch.setattr(FusedAdamW, "step", lambda self, closure=None: torch.zeros(()))
    result = run_cell(_cell(bench), SEED, 0.3, False, "cpu")
    assert not result["correct"], result["compared"]
