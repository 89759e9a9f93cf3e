"""The per-layer metrics that read the program's own spans and counter
(`harness/spans.py`): None without a profile and on the other kind of run,
and in a traced tiny run of each cell on the CPU, each of the cell's
readers reports, but the graph's wait: on the CPU no train step replays a
CUDA graph, so nothing enters `train.graph_wait`."""

from __future__ import annotations

import pytest

from harness import spec
from run import run_cell

from _tiny import tiny_bench

SEED = 2 ** 31 + 41
TRAIN = ("step_host_ms.train", "graph_wait_ms.train")
# spans the program enters only on a card
CARD_ONLY = ("graph_wait_ms.train",)
EVAL = ("forward_host_ms.eval", "stage_host_ms.eval", "fetch_wait_ms.eval", "h2d_mb.eval")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="module")
def traced(bench):
    """Each cell's traced run, with its per-layer metrics."""
    return {name: run_cell(spec.load_cell(name, *bench), SEED, 0.3, True, "cpu")
            for name in ("slot-k400-train", "slot-hvu-train", "slot-k400-eval")}


@pytest.mark.parametrize("name", TRAIN + EVAL)
def test_a_reader_reads_nothing_without_a_profile_or_of_the_other_kind(name):
    kind = name.rsplit(".", 1)[1]
    other = "eval" if kind == "train" else "train"
    read = spec.reader(name)
    assert read({"record": {"kind": kind}}) is None
    assert read({"record": {"kind": other}, "profile": {"units": 3}}) is None


def test_the_graph_wait_is_its_span_self_ms_per_steady_step(monkeypatch):
    """The wait is read over the steady steps, not over the traced ones,
    whose first steps follow a synchronize and wait less."""
    from devias_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "train.graph_wait": {"calls": 3, "total_ns": 3_000_000, "self_ns": 1_500_000}})
    steady = {"units": 3, "spans": {"train.graph_wait": {"calls": 3, "total_ns": 9_000_000, "self_ns": 6_000_000}}}
    read = spec.reader("graph_wait_ms.train")
    assert read({"record": {"kind": "train"}, "profile": {"units": 3, "steady": steady}}) == 2.0
    assert read({"record": {"kind": "train"}, "profile": {"units": 3, "steady": None}}) is None
    assert read({"record": {"kind": "eval"}, "profile": {"units": 3, "steady": steady}}) is None


def test_the_steady_steps_leave_the_traced_tally_to_the_traced_steps(bench):
    """A train entry's profile reads the spans of its steady steps apart,
    and the program's tally then holds the traced steps alone."""
    from devias_tpu_torch.utils import profiling

    from harness import entries

    c = spec.load_cell("slot-k400-train", *bench)
    entry = spec.entry(c.traffic["entry"]).make(c.config, c.traffic, SEED, "cpu")
    entry.setup()
    prof = entry.profile(2)
    assert prof["steady"]["units"] == 2
    assert prof["steady"]["spans"]["train.step"]["calls"] == 2
    assert profiling.span_totals()["train.step"]["calls"] == 2
    assert entries.STEADY_LEAD > 2
    entry.release()


@pytest.mark.parametrize("name", ["slot-k400-train", "slot-hvu-train", "slot-k400-eval"])
def test_a_traced_run_reports_its_span_metrics(traced, bench, name):
    result = traced[name]
    assert result["correct"], result["compared"]
    listed = {m["name"] for m in spec.load_cell(name, *bench).per_layer} & set(TRAIN + EVAL)
    assert ("graph_wait_ms.train" in listed) == name.endswith("-train")
    listed -= set(CARD_ONLY)
    assert listed and all(isinstance(result["metrics"][m]["value"], float) for m in listed)
    assert set(result["metrics"]) & set(TRAIN + EVAL) == listed


@pytest.mark.parametrize("name", ["slot-k400-train", "slot-hvu-train"])
def test_the_train_children_fit_in_the_step(traced, name):
    """The step's span reads; its graph wait, a child of the step on a
    card, reads nothing where no graph replays."""
    got = {k: v["value"] for k, v in traced[name]["metrics"].items() if k in TRAIN}
    assert got.keys() == {"step_host_ms.train"} and got["step_host_ms.train"] > 0, got


def test_the_eval_forward_leaves_out_its_staging(traced):
    got = {k: v["value"] for k, v in traced["slot-k400-eval"]["metrics"].items() if k in EVAL}
    # nothing crosses to a card on the CPU
    assert got["stage_host_ms.eval"] == 0.0 and got["h2d_mb.eval"] == 0.0
    assert got["forward_host_ms.eval"] > 0 and got["fetch_wait_ms.eval"] > 0
