"""The per-layer metrics that read the program's own spans and counter
(`harness/spans.py`): None without a profile and on the other kind of run,
and in a traced tiny run of each cell on the CPU, each of the cell's
readers reports, the train step's children within the step."""

from __future__ import annotations

import pytest

from harness import spec
from run import run_cell

from _tiny import tiny_bench

SEED = 2 ** 31 + 41
TRAIN = ("step_host_ms.train", "fame_host_ms.train", "teacher_host_ms.train", "student_host_ms.train",
         "agg_host_ms.train", "loss_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train")
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


@pytest.mark.parametrize("name", ["slot-k400-train", "slot-hvu-train", "slot-k400-eval"])
def test_a_traced_run_reports_its_span_metrics(traced, bench, name):
    result = traced[name]
    assert result["correct"], result["compared"]
    listed = {m["name"] for m in spec.load_cell(name, *bench).per_layer} & set(TRAIN + EVAL)
    assert listed and all(isinstance(result["metrics"][m]["value"], float) for m in listed)
    assert set(result["metrics"]) & set(TRAIN + EVAL) == listed
    assert ("teacher_host_ms.train" in listed) == (name == "slot-k400-train")


@pytest.mark.parametrize("name", ["slot-k400-train", "slot-hvu-train"])
def test_the_train_children_fit_in_the_step(traced, name):
    got = {k: v["value"] for k, v in traced[name]["metrics"].items() if k in TRAIN}
    children = sum(v for k, v in got.items() if k != "step_host_ms.train")
    assert 0 < children <= got["step_host_ms.train"]
    assert all(v > 0 for v in got.values()), got


def test_the_eval_forward_leaves_out_its_staging(traced):
    got = {k: v["value"] for k, v in traced["slot-k400-eval"]["metrics"].items() if k in EVAL}
    # nothing crosses to a card on the CPU
    assert got["stage_host_ms.eval"] == 0.0 and got["h2d_mb.eval"] == 0.0
    assert got["forward_host_ms.eval"] > 0 and got["fetch_wait_ms.eval"] > 0
