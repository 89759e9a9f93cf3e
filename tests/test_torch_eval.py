"""The port's eval step and protocols against the JAX package's, on the
CPU: the same logits give the same accuracies and byte-identical result
files, and a small model driven through both gives the same accuracies
and logits within float32 tolerance (1e-4, as in test_torch_models).
Entry points raise when CUDA is absent and no CPU was asked for."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.eval import protocols as jprot
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu.train.step import make_eval_step as jax_make_eval_step
from devias_tpu_torch.ckpt.from_jax import load_jax_params
from devias_tpu_torch.eval import merge_results, parse_result_file
from devias_tpu_torch.eval import protocols as tprot
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train.step import make_eval_step

SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=2, depth=2, embed_dim=64, num_heads=4)


def _batches(rng, n_batches, batch, width=None, clips=False):
    out = []
    for b in range(n_batches):
        n = batch if b < n_batches - 1 else batch - 1  # ragged last batch
        videos = (rng.normal(size=(n, 4, 32, 32, 3)) if clips else rng.normal(size=(n, width))).astype(np.float32)
        out.append({
            "videos": videos,
            "labels": rng.integers(0, 5, size=n),
            "video_id": [f"vid{b}_{i}" for i in range(n)],
            "chunk": rng.integers(0, 2, size=n),
            "split": rng.integers(0, 3, size=n),
        })
    return out


def test_protocols_match_jax_on_the_same_logits(tmp_path):
    """forward returns the batch itself as logits, so both protocols see
    identical numbers."""
    batches = _batches(np.random.default_rng(0), 3, 4, width=9)
    t_fwd = lambda v: torch.from_numpy(v)  # noqa: E731
    j_fwd = lambda v: jnp.asarray(v)  # noqa: E731
    teacher = lambda v: torch.from_numpy(v[:, ::-1].copy())  # noqa: E731

    assert tprot.validation_one_epoch(batches, t_fwd, 4, device="cpu") == \
        jprot.validation_one_epoch(batches, j_fwd, 4)
    for label_fn in (None, teacher):
        tdir, jdir = tmp_path / f"t{label_fn is None}", tmp_path / f"j{label_fn is None}"
        got = tprot.final_test(batches, t_fwd, 4, str(tdir), scene_label_fn=label_fn, device="cpu")
        want = jprot.final_test(batches, j_fwd, 4, str(jdir),
                                scene_label_fn=None if label_fn is None else (lambda v: v[:, ::-1]))
        assert got == want
        assert (tdir / "0.txt").read_bytes() == (jdir / "0.txt").read_bytes()
        assert merge_results(str(tdir), 1) == jprot.merge_results(str(jdir), 1)


def test_eval_step_and_protocols_match_jax_model(tmp_path):
    rng = np.random.default_rng(1)
    batches = _batches(rng, 2, 2, clips=True)
    jm = jax_create_model("slot_vit_base_patch16_224", fused_attention=True, fused_interpret=True, **SLOT)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(batches[0]["videos"]))["params"]
    params = dict(params, head=jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32) * 0.1, params["head"]))
    tm = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, fused_attention=True, **SLOT)
    load_jax_params(tm, params, "slot")

    j_step = jax.jit(jax_make_eval_step(jm, "action_logit"))
    t_step = make_eval_step(tm, "action_logit", device="cpu")
    out = t_step(batches[0]["videos"])
    assert isinstance(out, torch.Tensor) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), np.asarray(j_step(params, batches[0]["videos"])), rtol=1e-4, atol=1e-4)
    assert set(make_eval_step(tm, device="cpu")(batches[0]["videos"])) >= {"slots_head", "attn"}

    got = tprot.final_test(batches, t_step, 2, str(tmp_path / "t"), device="cpu")
    want = jprot.final_test(batches, lambda v: j_step(params, v), 2, str(tmp_path / "j"))
    assert got == want
    rows_t = parse_result_file(str(tmp_path / "t" / "0.txt"))
    rows_j = parse_result_file(str(tmp_path / "j" / "0.txt"))
    assert [r[0] for r in rows_t] == [r[0] for r in rows_j]
    for rt, rj in zip(rows_t, rows_j):
        np.testing.assert_allclose(rt[1], rj[1], rtol=1e-4, atol=1e-4)
        assert rt[2:] == rj[2:]


def test_pipelined_keeps_order_and_dispatches_ahead():
    events = []

    def dispatch(b):
        events.append(("dispatch", b))
        return torch.tensor([b]), b

    for out, meta in tprot._pipelined(range(3), dispatch):
        events.append(("yield", meta))
        assert int(out[0]) == meta
    assert events == [("dispatch", 0), ("dispatch", 1), ("yield", 0), ("dispatch", 2), ("yield", 1), ("yield", 2)]


def test_scuba_and_hat_loops(tmp_path):
    batches = _batches(np.random.default_rng(2), 1, 3, width=9)
    fwd = lambda v: torch.from_numpy(v)  # noqa: E731
    res = tprot.run_scuba(lambda variant: batches, fwd, 3, str(tmp_path), scuba_variants=("vqgan",), device="cpu")
    assert res["vqgan"] == dict(zip(("acc1", "acc5"), merge_results(str(tmp_path / "scuba" / "vqgan"), 1)))
    hat = tprot.hat_eval(lambda ver, split: batches, fwd, 3, str(tmp_path), versions=("far",), device="cpu")
    assert hat["far"] == res["vqgan"]  # the same batches in every split


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("vit_base_patch16_224", depth=1, embed_dim=64, num_heads=4)
    model = create_model("vit_base_patch16_224", device="cpu", depth=1, embed_dim=64, num_heads=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_step(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprot.validation_one_epoch([], lambda v: v, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprot.final_test([], lambda v: v, 2, str(tmp_path))
    with pytest.raises(ValueError, match="model is on cpu"):
        make_eval_step(model, device="meta")
