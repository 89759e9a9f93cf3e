"""The port's training-health tools (`devias_tpu_torch/scripts/`) against
the JAX package's scripts, on the CPU:

(a) the clip builders bit for bit: `health_run.make_clip` and `make_pool`
    against `scripts/health_run.py`'s, `full_scale_overfit.overfit_clips`
    against the loop of `scripts/full_scale_overfit.py:40-49`. The JAX
    code is taken from the scripts' source with `ast` and run with numpy:
    importing `health_run.py` would set JAX's compilation cache for the
    whole process, and importing `full_scale_overfit.py` runs 200 ViT-B
    steps;
(b) `health_run.slot_accuracies` against the JAX script's probe formula
    (`scripts/health_run.py:181-200`, re-stated here, since `accs` is a
    closure in its `main`) on a small slot model (depth 2, width 64, 4
    heads, 32x32, 4 frames) in float32 whose weights cross through
    `load_jax_params`; the JAX model takes its Pallas attention in
    interpret mode: logits within 1e-4 relative, the four counts equal;
(c) a tiny run of each tool through its functions: finite losses, the
    logged steps, and the health run's EMA probe reading the EMA (which
    differs from the parameters after a few steps, and so do its logits).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.nn import create_model as jax_create_model
from devias_tpu_torch.ckpt.from_jax import load_jax_params
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.scripts import full_scale_overfit, health_run
from devias_tpu_torch.train import make_eval_step

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(depth=2, embed_dim=64, num_heads=4)
# a pool the clip builders accept (the block is 40 pixels, its origin
# drawn in [20, res - 60)) and the tiny models take in
TINY_GEOMETRY = dict(res=96, frames=4)


def _script_namespace(script: str, keep) -> dict:
    """Run the top-level statements of `scripts/<script>` that `keep(node)`
    selects, with numpy as `np`; return the namespace."""
    tree = ast.parse((ROOT / "scripts" / script).read_text())
    body = [node for node in tree.body if keep(node)]
    ns = {"np": np}
    exec(compile(ast.Module(body=body, type_ignores=[]), script, "exec"), ns)
    return ns


def _health_names(node) -> bool:
    if isinstance(node, ast.FunctionDef):
        return node.name in ("make_clip", "make_pool")
    return isinstance(node, ast.Assign) and any(
        isinstance(t, (ast.Name, ast.Tuple)) and {n.id for n in ast.walk(t) if isinstance(n, ast.Name)}
        <= {"N_MOTION", "N_SCENE", "B", "RES", "T"} for t in node.targets)


@pytest.mark.parametrize("seed", [0, 1234])
def test_make_pool_is_the_jax_scripts_bitwise(seed):
    jax_ns = _script_namespace("health_run.py", _health_names)
    want = jax_ns["make_pool"](np.random.default_rng(seed), 1)
    got = health_run.make_pool(np.random.default_rng(seed), 1)
    assert want[0].shape == (12, 16, 224, 224, 3) and want[0].dtype == np.float32
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    clip_rng_jax, clip_rng = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    assert np.array_equal(jax_ns["make_clip"](clip_rng_jax, 3, 2), health_run.make_clip(clip_rng, 3, 2))


def test_overfit_clips_are_the_jax_scripts_bitwise():
    src = (ROOT / "scripts" / "full_scale_overfit.py").read_text()
    tree = ast.parse(src)
    start = next(i for i, n in enumerate(tree.body)
                 if isinstance(n, ast.Assign) and ast.unparse(n.targets[0]) == "rng")
    end = next(i for i in range(start, len(tree.body)) if isinstance(tree.body[i], ast.For))
    ns = {"np": np, "B": full_scale_overfit.B}
    exec(compile(ast.Module(body=tree.body[start:end + 1], type_ignores=[]), "full_scale_overfit.py", "exec"), ns)
    vids, labels = full_scale_overfit.overfit_clips(full_scale_overfit.B)
    assert ns["vids"].shape == (12, 16, 224, 224, 3)
    assert vids.dtype == ns["vids"].dtype and np.array_equal(vids, ns["vids"])
    assert np.array_equal(labels, np.arange(12) % 10)


def _jax_probe_counts(jm, params, videos, am, sc, num_motion, batch):
    """`scripts/health_run.py:181-191` and its returned shares, on JAX's
    logits; also returns the logits."""
    probe = jax.jit(lambda p, v: jm.apply({"params": p}, v, deterministic=True))
    N = len(am)
    a_hit = s_hit = a_x = s_x = 0
    logits = []
    for i in range(0, N, batch):
        out = probe(params, jnp.asarray(videos[i : i + batch]))
        a_log, s_log = np.asarray(out["action_logit"]), np.asarray(out["scene_logit"])
        logits.append((a_log, s_log))
        al, sl = am[i : i + batch], sc[i : i + batch]
        a_hit += (a_log[:, :num_motion].argmax(-1) == al).sum()
        s_hit += (s_log[:, num_motion:].argmax(-1) == sl).sum()
        a_x += (a_log[:, num_motion:].argmax(-1) == sl).sum()
        s_x += (s_log[:, :num_motion].argmax(-1) == al).sum()
    return (a_hit, s_hit, a_x, s_x), logits


def test_slot_accuracies_is_the_jax_probe():
    kw = dict(num_classes=health_run.N_MOTION, num_scene_classes=health_run.N_SCENE, num_latents=2, agg_depth=8,
              agg_weights_tie=True, **TINY)
    jm = jax_create_model("slot_vit_base_patch16_224", fused_attention=True, fused_interpret=True, **kw)
    rng = np.random.default_rng(3)
    videos = rng.normal(size=(24, 4, 32, 32, 3)).astype(np.float32)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(3)}, jnp.asarray(videos[:2]))["params"]
    # a spread head, so the slot selection and the argmaxes are not ties
    params = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    am, sc = rng.integers(0, 4, size=24), rng.integers(0, 3, size=24)
    counts, want = _jax_probe_counts(jm, params, videos, am, sc, health_run.N_MOTION, 12)

    model = load_jax_params(create_model("slot_vit_base_patch16_224", device="cpu", fused_attention=True,
                                         img_size=32, **kw), params, "slot")
    probe = make_eval_step(model, device="cpu")
    for i, (a_log, s_log) in enumerate(want):
        out = probe(videos[12 * i : 12 * (i + 1)])
        for k, w in (("action_logit", a_log), ("scene_logit", s_log)):
            np.testing.assert_allclose(out[k].numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=k)
    got = health_run.slot_accuracies(model, torch.from_numpy(videos), am, sc, health_run.N_MOTION, 12)
    shares = [got[k] * 24 for k in ("action_slot_motion", "scene_slot_scene", "action_slot_scene",
                                    "scene_slot_motion")]
    assert shares == [int(c) for c in counts]
    assert 0 < sum(shares) < 4 * 24


def test_overfit_runs_tiny_and_logs_its_steps():
    result = full_scale_overfit.train_overfit(steps=22, device="cpu", widths=TINY, **TINY_GEOMETRY)
    assert [s for s, _ in result["history"]] == [0, 20, 21]
    assert all(np.isfinite(m["loss"]) for _, m in result["history"])
    assert len(result["acc_per_step"]) == 22 and result["acc_per_step"][21] == result["history"][-1][1]["class_acc"]
    assert result["ms_per_step"] > 0
    assert set(result["history"][0][1]) >= {"loss", "class_acc", "action_loss", "scene_loss", "grad_norm", "lr"}


def test_health_run_runs_tiny_and_its_ema_probe_reads_the_ema():
    result = health_run.run_health(steps=4, per_combo=1, device="cpu", widths=TINY, **TINY_GEOMETRY)
    assert [s for s, _ in result["history"]] == [0, 3]
    assert all(np.isfinite(m["loss"]) for _, m in result["history"])
    state = result["state"]
    assert state.step == 4
    params = dict(state.model.named_parameters())
    moved = [n for n, e in state.ema_params.items() if not torch.equal(e, params[n].detach())]
    assert len(moved) > len(params) // 2

    # the EMA model: the EMA's parameters, the trained model's buffers, and
    # the trained model left as it was
    before = {n: p.detach().clone() for n, p in params.items()}
    ema = health_run.ema_model(state)
    assert all(torch.equal(p, state.ema_params[n]) for n, p in ema.named_parameters())
    assert all(torch.equal(b, b0) for (_, b), (_, b0) in zip(ema.named_buffers(), state.model.named_buffers()))
    assert all(torch.equal(p.detach(), before[n]) for n, p in state.model.named_parameters())
    videos, am, sc = health_run.make_pool(np.random.default_rng(0), 1, **TINY_GEOMETRY)
    out_ema = make_eval_step(ema, device="cpu")(videos)
    out_params = make_eval_step(state.model, device="cpu")(videos)
    assert not torch.equal(out_ema["slots_head"], out_params["slots_head"])
    assert result["ema"] == health_run.slot_accuracies(ema, videos, am, sc, health_run.N_MOTION)
    assert result["train"] == health_run.slot_accuracies(state.model, videos, am, sc, health_run.N_MOTION)
    assert set(result["held_out"]) == set(result["train"])
