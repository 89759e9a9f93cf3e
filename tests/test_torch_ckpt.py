"""The port's checkpoints: the torch-native save and auto-resume round trip
(bitwise), and reference-layout `.pth` import against the JAX package's.
A tiny JAX slot model and CLS teacher are exported with
`devias_tpu/ckpt/torch_export.py::save_torch_checkpoint`, rewritten into the
DeepSpeed container ('module') with torch.compile's '_orig_mod.' key
prefix, and loaded two ways: the port's `torch_import` into a port model,
and the JAX `import_torch_state_dict` + `merge_params` carried over by
`ckpt/from_jax.py`. The models must be bitwise equal, except a head the
surgery drops, which keeps each side's own initial values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.ckpt.torch_export import save_torch_checkpoint
from devias_tpu.ckpt.torch_import import import_torch_state_dict as jax_import
from devias_tpu.ckpt.torch_import import load_torch_checkpoint_file as jax_load_file
from devias_tpu.ckpt.torch_import import merge_params as jax_merge
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu_torch.aug import FAMEConfig
from devias_tpu_torch.ckpt import (
    auto_resume,
    import_torch_state_dict,
    latest_checkpoint_step,
    load_jax_params,
    load_reference_checkpoint,
    load_torch_checkpoint_file,
    save_checkpoint,
)
from devias_tpu_torch.losses import SlotLossConfig
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import OptimConfig, TrainState, TrainStepConfig, make_optimizer, make_slot_train_step

SMALL = dict(depth=2, embed_dim=64, num_heads=4)
X = np.zeros((1, 4, 32, 32, 3), np.float32)


def _port_slot(num_classes=5, seed=0, tie=True):
    return create_model("slot_vit_base_patch16_224", device="cpu", seed=seed, img_size=32, num_classes=num_classes,
                        num_latents=2, agg_depth=2, agg_weights_tie=tie, **SMALL)


def _port_teacher(seed=1):
    return create_model("vit_base_patch16_224", device="cpu", seed=seed, num_classes=365, use_mean_pooling=False,
                        **SMALL)


def _state(model, seed):
    opt, lr_fn = make_optimizer(model, OptimConfig(lr=1e-3, total_steps=10, warmup_steps=1), device="cpu")
    return TrainState.create(model, opt, use_ema=True, ema_decay=0.9, device="cpu"), lr_fn


def test_save_auto_resume_round_trip_is_bitwise(tmp_path):
    model, teacher = _port_slot(), _port_teacher()
    state, lr_fn = _state(model, 0)
    step = make_slot_train_step(model, teacher, state.optimizer, SlotLossConfig(5, 365),
                                TrainStepConfig(fame=FAMEConfig(beta=0.5, prob_aug=1.0)), lr_fn, device="cpu")
    gen = torch.Generator().manual_seed(3)
    rng = np.random.default_rng(0)
    batch = {"videos": rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32), "labels": np.array([1, 3])}
    for _ in range(2):
        step(state, batch, generator=gen)
    save_checkpoint(str(tmp_path), 0, state, gen)
    save_checkpoint(str(tmp_path), 1, state, gen)
    assert latest_checkpoint_step(str(tmp_path)) == 1

    fresh, _ = _state(_port_slot(seed=9), 9)
    gen2 = torch.Generator().manual_seed(11)
    restored, epoch = auto_resume(str(tmp_path), fresh, gen2)
    assert restored is fresh and epoch == 1 and fresh.step == state.step == 2
    assert fresh.optimizer.count == state.optimizer.count == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    for k, v in state.ema_params.items():
        assert torch.equal(fresh.ema_params[k], v), k
    for p, q in zip(state.optimizer.param_groups[0]["params"], fresh.optimizer.param_groups[0]["params"]):
        for moment in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state.optimizer.state[p][moment], fresh.optimizer.state[q][moment])
    assert torch.equal(gen.get_state(), gen2.get_state())
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=gen2))
    assert auto_resume(str(tmp_path / "none"), fresh) == (None, None)


def _jax_params(name, seed, **kw):
    model = jax_create_model(name, **kw)
    return model.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(X))["params"]


def _export(path, params, kind, agg_depth=2, pos_embed=None):
    """save_torch_checkpoint, then the keys under '_orig_mod.' in a
    'module' container; `pos_embed` added as a checkpoint trained at
    another patch grid would carry it."""
    save_torch_checkpoint(str(path), params, kind, agg_depth=agg_depth, epoch=3)
    sd = torch.load(str(path), weights_only=False)["model"]
    if pos_embed is not None:
        sd["pos_embed"] = torch.from_numpy(pos_embed)
    torch.save({"module": {f"_orig_mod.{k}": v for k, v in sd.items()}, "epoch": 3}, str(path))


@pytest.mark.parametrize("case", ["head_mismatch", "pos_embed_untied"])
def test_slot_import_matches_jax_import(tmp_path, case):
    tie = case == "head_mismatch"
    src = _jax_params("slot_vit_base_patch16_224", 0, num_classes=5, num_latents=2, agg_depth=2,
                      agg_weights_tie=tie, **SMALL)
    pos = None
    if case == "pos_embed_untied":
        # a 3x3 patch grid over 2 frame pairs, interpolated to the 2x2 grid
        # of 32x32 clips
        pos = np.random.default_rng(1).normal(size=(1, 2 * 9, 64)).astype(np.float32)
    path = tmp_path / "slot.pth"
    _export(path, src, "slot", pos_embed=pos)
    classes = 7 if case == "head_mismatch" else 5  # 372 outputs against the checkpoint's 370
    kw = dict(expected_head_out=classes + 365, dst_spatial=2, frames_tokens=2)
    unique = 1 if tie else 2

    target = _jax_params("slot_vit_base_patch16_224", 5, num_classes=classes, num_latents=2, agg_depth=2,
                         agg_weights_tie=tie, **SMALL)
    imported = jax_import(jax_load_file(str(path)), "slot", agg_unique_layers=unique, **kw)
    merged, jax_report = jax_merge(target, imported)
    via_jax = load_jax_params(_port_slot(classes, seed=2, tie=tie), merged, "slot")

    port = _port_slot(classes, seed=4, tie=tie)
    init_head = {k: v.clone() for k, v in port.state_dict().items() if k.startswith("head.")}
    _, report = load_reference_checkpoint(port, str(path), "slot", agg_depth=2, agg_unique_layers=unique, **kw)
    dropped = case == "head_mismatch"
    for k, v in port.state_dict().items():
        if k.startswith("head.") and dropped:
            assert torch.equal(v, init_head[k]), k
        else:
            assert torch.equal(v, via_jax.state_dict()[k]), k
    assert any(k.startswith("head.") for k in report["loaded"]) != dropped
    assert any("head" in k for k in jax_report["loaded"]) != dropped
    if pos is not None:
        ours = import_torch_state_dict(load_torch_checkpoint_file(str(path)), "slot", agg_depth=2,
                                       agg_unique_layers=unique, **kw)["pos_embed"]
        assert ours.shape == (1, 2 * 4, 64)
        np.testing.assert_array_equal(ours.numpy(), imported["backbone"]["pos_embed"])
        # the slot model has fixed sinusoid positions: reported, not loaded
        assert report["unused_in_ckpt"] == ["pos_embed"] and jax_report["unused_in_ckpt"] == ["/backbone/pos_embed"]


def test_teacher_import_matches_jax_import(tmp_path):
    src = _jax_params("vit_base_patch16_224", 1, num_classes=365, use_mean_pooling=False, **SMALL)
    path = tmp_path / "teacher.pth"
    _export(path, src, "plain")
    target = _jax_params("vit_base_patch16_224", 6, num_classes=365, use_mean_pooling=False, **SMALL)
    merged, _ = jax_merge(target, jax_import(jax_load_file(str(path)), "plain", expected_head_out=365))
    via_jax = load_jax_params(_port_teacher(seed=2), merged, "plain")
    port, report = load_reference_checkpoint(_port_teacher(seed=4), str(path), "plain", expected_head_out=365)
    assert sorted(report["loaded"]) == sorted(port.state_dict())
    for k, v in port.state_dict().items():
        assert torch.equal(v, via_jax.state_dict()[k]), k


def test_model_key_and_prefix(tmp_path):
    """--model_key picks the container entry; --model_prefix strips a key
    prefix (the JAX loader reads only 'model', 'module' and 'state_dict')."""
    sd = {"net.cls_token": torch.ones(1, 1, 4), "net.head.weight": torch.zeros(2, 4), "other": 3}
    torch.save({"weights": sd, "model": {"x": torch.zeros(1)}}, str(tmp_path / "c.pth"))
    got = load_torch_checkpoint_file(str(tmp_path / "c.pth"), model_key="weights", model_prefix="net.")
    assert sorted(got) == ["cls_token", "head.weight"]
    assert sorted(load_torch_checkpoint_file(str(tmp_path / "c.pth"))) == ["x"]
