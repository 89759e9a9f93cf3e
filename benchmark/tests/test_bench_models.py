"""The lookups by name (`spec.model`, `spec.entry`) give what the literal
tables before them gave: tokens, operations per clip, K1's bound in a
profiled step, the parameter shapes the weights are drawn for, and the
entry classes, for the two shipped configurations and their tiny copies.
The old formulas are written out here as they stood."""

from __future__ import annotations

import json
import os

import pytest
import torch

from harness import entries, layers, roofline, spec
from harness.spec import ROOT
from harness.weights import shapes_of
from reference import model as ref_model

from _tiny import tiny_bench, tiny_config

SEED = 2 ** 31 + 67
SHIPPED = {name: json.load(open(os.path.join(ROOT, f"benchmark/configs/{name}.json")))
           for name in ("devias-slot-vitb16-k400", "devias-slot-vitb16-hvu")}
CONFIGS = {**SHIPPED, **{f"tiny-{k}": tiny_config(v) for k, v in SHIPPED.items()}}
K400, HVU = SHIPPED["devias-slot-vitb16-k400"], SHIPPED["devias-slot-vitb16-hvu"]


def old_tokens(m):
    n = (m["num_frames"] // m["tubelet_size"]) * (m["img_size"] // m.get("patch_size", 16)) ** 2
    return n + int(m["name"] == "vit_base_patch16_224" and not m.get("use_mean_pooling", True))


def old_vit_flops_per_clip(N, C=768, depth=12):
    return depth * (24 * N * C * C + 4 * N * N * C)


def old_flops_per_clip(cfg, train):
    m = cfg["model"]
    total = (3 if train else 1) * old_vit_flops_per_clip(old_tokens(m), m["embed_dim"], m["depth"])
    t = cfg.get("teacher")
    if t:
        total += old_vit_flops_per_clip(old_tokens(t), t["embed_dim"], t["depth"])
    return total


def old_attention_bound_ms(cfg, kind, n, B):
    m, t = cfg["model"], cfg.get("teacher")
    H, D = m["num_heads"], m["embed_dim"] // m["num_heads"]
    Ns = old_tokens(m)
    if kind == "train":
        fwd = [(old_tokens(t) if t else Ns, 1.0)]
    else:
        total = m["depth"] + (t["depth"] if t else 0)
        fwd = [(Ns, m["depth"] / total)] + ([(old_tokens(t), t["depth"] / total)] if t else [])
    bound = n.get("K1-fwd", 0) * sum(w * roofline.attention_bound_ms(B, H, N, D) for N, w in fwd)
    bound += n.get("K1-fwd-stats", 0) * roofline.attention_bound_ms(B, H, Ns, D, stats=True)
    bound += n.get("K1-bwd", 0) * roofline.attention_bwd_bound_ms(B, H, Ns, D)
    return bound


def old_model_shapes(cfg):
    classes = {"slot_vit_base_patch16_224": ref_model.SlotViT, "vit_base_patch16_224": ref_model.PlainViT}
    return {key: shapes_of(classes[cfg[key]["name"]](cfg[key]).named_parameters())
            for key in ("model", "teacher") if cfg.get(key)}


def test_the_k400_literals():
    assert roofline.tokens(K400["model"]) == 1568 and roofline.tokens(K400["teacher"]) == 1569
    assert roofline.tokens(HVU["model"]) == 1568
    student, teacher = 356989796352, 357275308032
    assert roofline.flops_per_clip(K400, train=True) == 3 * student + teacher
    assert roofline.flops_per_clip(K400, train=False) == student + teacher
    assert roofline.flops_per_clip(HVU, train=True) == 3 * student
    assert roofline.flops_per_clip(HVU, train=False) == student


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tokens_and_operations_are_the_old_ones(name):
    cfg = CONFIGS[name]
    for key in ("model", "teacher"):
        if cfg.get(key):
            assert roofline.tokens(cfg[key]) == old_tokens(cfg[key])
    for train in (True, False):
        assert roofline.flops_per_clip(cfg, train) == old_flops_per_clip(cfg, train)


def test_the_mlp_width_enters_the_operations():
    # at ratio 4 the old 24 N C^2; otherwise 8 N C^2 + 4 N C Hm
    for N, C, depth in ((1568, 768, 12), (8, 64, 2), (2048, 1408, 40)):
        assert roofline.vit_flops_per_clip(N, C, depth) == old_vit_flops_per_clip(N, C, depth)
    assert roofline.vit_flops_per_clip(2048, 1408, 40, 2.0) == 40 * (
        8 * 2048 * 1408 ** 2 + 4 * 2048 * 1408 * 2816 + 4 * 2048 ** 2 * 1408)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("kind", ["train", "eval"])
def test_the_attention_bound_is_the_old_one(name, kind):
    cfg = CONFIGS[name]
    n = {"K1-fwd": 12, "K1-fwd-stats": 12, "K1-bwd": 12} if kind == "train" else {"K1-fwd": 24}
    run = {"record": {"kind": kind}, "config": cfg, "traffic": {"batch": 12},
           "profile": {"launches_per_unit": n, "device_ms_by_class": {layers.ATTENTION: 17.2}}}
    assert layers.attention_roofline(run, kind) == old_attention_bound_ms(cfg, kind, n, 12) / 17.2 * 100.0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_weights_are_drawn_for_the_old_shapes(name):
    with torch.device("meta"):
        got, old = entries.model_shapes(CONFIGS[name]), old_model_shapes(CONFIGS[name])
    assert got == old


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell, name, cls, hvu", [("slot-k400-train", "slot_train", entries.TrainEntry, False),
                                                  ("slot-hvu-train", "hvu_train", entries.TrainEntry, True),
                                                  ("slot-k400-eval", "final_test", entries.FinalTestEntry, None)])
def test_the_entries_make_the_old_classes(bench, cell, name, cls, hvu):
    c = spec.load_cell(cell, *bench)
    assert c.traffic["entry"] == name
    entry = spec.entry(name).make(c.config, c.traffic, SEED, "cpu")
    try:
        assert type(entry) is cls and getattr(entry, "hvu", None) is hvu
    finally:
        getattr(entry, "close", lambda: None)()
