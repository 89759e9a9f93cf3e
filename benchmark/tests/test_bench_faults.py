"""A whole run of a tiny cell on the CPU (the harness's look for a card
skipped), sound and with the timed path broken underneath: each fault the
cell can have must turn `correct` false. One card runs no exchange
between chips, so that fault has no cell here."""

from __future__ import annotations

import pytest
import torch

import devias_tpu_torch.eval.protocols as protocols
import devias_tpu_torch.nn.models as models
import devias_tpu_torch.train as train
import devias_tpu_torch.train.step as train_step
from devias_tpu_torch.train.optim import FusedAdamW
from harness import spec
from run import run_cell

from _tiny import tiny_bench

SEED = 2 ** 31 + 23


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(str(tmp_path_factory.mktemp("bench")))


def _run(bench, name, trace=False):
    return run_cell(spec.load_cell(name, *bench), SEED, 0.3, trace, "cpu")


@pytest.mark.parametrize("name", ["slot-k400-train", "slot-hvu-train", "slot-k400-eval"])
def test_a_sound_run_is_correct(bench, name):
    result = _run(bench, name)
    assert result["correct"] and result["failed"] == 0, result["compared"]
    # a CPU run reports no device metric
    reported = {m["name"] for m in spec.load_cell(name, *bench).end_to_end}
    assert set(result["metrics"]) == reported - {"peak_mem_gib", "step_ms_p95"}
    assert list(result)[-1] == "compared"


def test_a_traced_run_reads_its_host_spans(bench):
    result = _run(bench, "slot-k400-train", trace=True)
    assert result["correct"] and "host_ms.train" in result["metrics"] and "breakdown" in result


def _unchanged(self, closure=None):
    return torch.zeros(())


def _half(loss):
    """The loss over the first half of the batch, its mean over that half."""
    def first_half(student, *args, **kw):
        B = student["slots_head"].shape[0]
        cut = [a[:B // 2] if isinstance(a, torch.Tensor) and a.dim() > 0 else a for a in args]
        total, action_logits, parts = loss({k: v[:B // 2] for k, v in student.items()}, *cut, **kw)
        return total, action_logits.repeat(2, 1)[:B], parts
    return first_half


@pytest.mark.parametrize("name", ["slot-k400-train", "slot-hvu-train"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(bench, name, fault, monkeypatch):
    if fault == "state_unchanged":
        # on the class torch's optimizer wraps its step on, so the undo holds
        monkeypatch.setattr(FusedAdamW, "step", _unchanged)
    else:
        monkeypatch.setattr(train_step, "devias_slot_loss", _half(train_step.devias_slot_loss))
        monkeypatch.setattr(train_step, "hvu_slot_loss", _half(train_step.hvu_slot_loss))
    result = _run(bench, name)
    assert not result["correct"], result["compared"]


def _altered(select):
    def altered(slots, slots_head, *args):
        out = select(slots, slots_head, *args)
        logit = out["scene_logit"].clone()
        logit[0] += 0.5
        out["scene_logit"] = logit
        return out
    return altered


def _other_slot(select):
    """The scene slot the criterion does not pick (of two)."""
    def other(slots, slots_head, *args):
        out = select(slots, slots_head, *args)
        idx = 1 - out["scene_idx"]
        out["scene_idx"] = idx
        out["scene_logit"] = slots_head.gather(1, idx.view(-1, 1, 1).expand(-1, 1, slots_head.shape[-1])).squeeze(1)
        return out
    return other


def _label_shifted(make):
    """The teacher's logits moved up one class, so its argmax is the next."""
    def made(model, key=None, device=None):
        step = make(model, key, device)
        return (lambda videos: step(videos).roll(1, dims=-1)) if key == "logits" else step
    return made


def _dropped(write):
    def dropped(path, ids, logits, labels, chunks, splits, header="0.0, 0.0"):
        return write(path, ids[:-1], logits[:-1], labels[:-1], chunks[:-1], splits[:-1], header)
    return dropped


@pytest.mark.parametrize("fault", ["answer_altered", "wrong_slot", "label_altered", "rows_missing"])
def test_a_broken_final_test_is_not_correct(bench, fault, monkeypatch):
    if fault == "answer_altered":
        # the first clip of every batch gets its scene logits moved by 0.5
        monkeypatch.setattr(models, "select_slots_by_head", _altered(models.select_slots_by_head))
    elif fault == "wrong_slot":
        monkeypatch.setattr(models, "select_slots_by_head", _other_slot(models.select_slots_by_head))
    elif fault == "label_altered":
        monkeypatch.setattr(train, "make_eval_step", _label_shifted(train.make_eval_step))
    else:
        monkeypatch.setattr(protocols, "write_result_file", _dropped(protocols.write_result_file))
    result = _run(bench, "slot-k400-eval")
    assert not result["correct"], result["compared"]
