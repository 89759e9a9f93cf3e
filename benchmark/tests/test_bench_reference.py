"""The plain reference against the port at tiny widths on the CPU, in
float32 (where the two compute the same function and differ by rounding
alone), and the float8 control and half-batch fault against both."""

from __future__ import annotations

import pytest

from harness import entries, spec

from _tiny import tiny_bench

SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(str(tmp_path_factory.mktemp("bench")))


def _train(bench, name):
    cell = spec.load_cell(name, *bench)
    entry = spec.entry(cell.traffic["entry"]).make(cell.config, cell.traffic, SEED, "cpu")
    entry.setup()
    entry.release()
    return entry


@pytest.mark.parametrize("name", ["slot-k400-train", "slot-hvu-train"])
def test_reference_follows_the_port_train_steps(bench, name):
    entry = _train(bench, name)
    gaps = entries.train_gaps(entry.readings, entry.reference_readings())
    # FAME, the teacher, drop-path, the slot loss and its terms, the
    # gradients and three AdamW updates: float32 rounding only
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-4, gaps


@pytest.mark.parametrize("name", ["slot-k400-train", "slot-hvu-train"])
def test_control_and_fault_read_far_above_the_program(bench, name):
    entry = _train(bench, name)
    ref = entry.reference_readings()
    program = entries.train_gaps(entry.readings, ref)
    control = entries.train_gaps(entry.reference_readings(quant="fp8"), ref)
    fault = entries.train_gaps(entry.reference_readings(half=True), ref)
    assert control["loss_gap"] > 100 * program["loss_gap"] and control["grad_gap"] > 100 * program["grad_gap"]
    assert fault["grad_gap"] > 0.1 and fault["change_gap"] > 0.05


def test_reference_follows_the_port_final_test(bench):
    cell = spec.load_cell("slot-k400-eval", *bench)
    entry = spec.entry(cell.traffic["entry"]).make(cell.config, cell.traffic, SEED, "cpu")
    try:
        entry.setup()
        rec = entry.window(0.3)
        entry.release()
        verdict = entry.check(cell.limits)
    finally:
        entry.close()
    got = {k: c["value"] for k, c in verdict["compared"].items()}
    assert rec["clips"] > 0 and got["missing"] == 0
    assert got["logit_gap"] < 1e-5 and got["select_gap"] == 0 and got["label_gap"] == 0, got


@pytest.mark.parametrize("fault, number", [("wrong_slot", "select_gap"), ("label_altered", "label_gap")])
def test_eval_faults_in_the_reference_read_above_their_limits(bench, fault, number):
    """The reference in the program's place, its selection or its label
    planted wrong: the number that watches it reads over its limit, the
    others stay at nought."""
    cell = spec.load_cell("slot-k400-eval", *bench)
    entry = spec.entry(cell.traffic["entry"]).make(cell.config, cell.traffic, SEED, "cpu")
    try:
        entry.setup()
        entry.window(0.3)
        entry.release()
        prog = entry.readings(cell.traffic["check_rows"])
        ref = entry.reference(prog["clips"])
    finally:
        entry.close()
    got = entries.eval_gaps({"missing": 0, "rows": entries.reference_rows(ref, fault)}, ref)
    assert got[number] > cell.limits[number], got
    assert all(v == 0 for k, v in got.items() if k != number), got


def test_the_matching_can_take_its_next_pair():
    import torch

    from reference.losses import match

    cost_a = torch.tensor([[-0.30, -0.10], [-0.10, -0.30]])
    cost_s = torch.tensor([[-0.20, -0.25], [-0.20, -0.10]])
    a, s, margin = match(cost_a, cost_s)
    assert a.tolist() == [0, 1] and s.tolist() == [1, 0]
    assert margin.tolist() == pytest.approx([0.25, 0.30])
    a, s, _ = match(cost_a, cost_s, torch.tensor([True, False]))
    assert a.tolist() == [1, 1] and s.tolist() == [0, 0]


def test_near_ties_are_resolved_both_ways(bench, monkeypatch):
    """With every sample counted as a near-tie, each may take its other
    slot assignment; the program's own assignment is among them, so its
    gaps stay at rounding, and assignments it did not take are not taken."""
    import reference.train as ref_train

    monkeypatch.setattr(ref_train, "MATCH_TIE", 1.0)
    entry = _train(bench, "slot-k400-train")
    ref = entry.reference_readings()
    near = ref["first_step"]["near"]
    assert len(near) == 4 and all(t["terms"]["action_loss"] != 0 or t["terms"]["scene_loss"] != 0 for t in near)
    resolved = entries.resolve_near_ties(entry.readings, ref, entries.moved_leaves(ref))
    assert resolved["swapped"] == []
    gaps = entries.train_gaps(entry.readings, ref)
    assert gaps["loss1_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4
    # a program whose gradients are the reference's with sample 0's
    # assignment swapped is judged against that resolution
    swapped = {k: float((g + (near[0]["grads"][k] if near[0]["grads"][k] is not None else 0)).norm())
               for k, g in ref["first_step"]["grads"].items()}
    resolved = entries.resolve_near_ties({**entry.readings, "grad_norms": swapped}, ref, entries.moved_leaves(ref))
    assert resolved["swapped"] == [near[0]["sample"]]


@pytest.mark.parametrize("seed", [0, 2, 3])
def test_near_ties_are_searched_whole(seed):
    """Six near-ties with changes that overlap across leaves, the program's
    gradients those of three of them taken together: the search finds
    those three, where toggling one at a time from none stops short of
    them on these seeds."""
    import torch

    from reference.losses import TERMS

    g = torch.Generator().manual_seed(seed)
    grads = {f"leaf{i}": torch.randn(7, generator=g) for i in range(5)}
    near = [{"sample": j, "terms": {k: 0.01 * (j + 1) for k in TERMS},
             "grads": {k: torch.randn(7, generator=g) * 0.7 if (i + j) % 3 else None for i, k in enumerate(grads)}}
            for j in range(6)]
    terms = {**{k: 1.0 for k in TERMS}, "loss": float(len(TERMS))}
    ref = {"first_step": {"terms": terms, "grads": grads, "near": near}}
    taken = dict(grads)
    for j in (1, 3, 4):
        taken = {k: v if near[j]["grads"][k] is None else v + near[j]["grads"][k] for k, v in taken.items()}
    prog = {"grad_norms": {k: float(v.norm()) for k, v in taken.items()}}
    resolved = entries.resolve_near_ties(prog, ref, list(grads))
    assert resolved["swapped"] == [1, 3, 4]
    assert resolved["grad_norms"] == pytest.approx(prog["grad_norms"], rel=1e-6)
    assert resolved["terms"]["action_loss"] == pytest.approx(1.0 + 0.02 + 0.04 + 0.05)
    assert resolved["terms"]["loss"] == pytest.approx(sum(resolved["terms"][k] for k in TERMS))
