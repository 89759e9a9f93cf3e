"""The port's multi-task baseline against the JAX package's, in float32 at
a small size (depth 2, width 64, 4 heads, 4x32x32 clips: the CLS token, 8
patches and the scene token, 10 tokens):

(a) `MultiTaskViT` through `load_jax_params` with `strict=True` against
    the flax model (its attention in Pallas interpret mode), separate and
    unified heads, the learnable pos-embed on and off: tokens and logits to
    1e-4 relative;
(b) `multi_task_loss` under KL and CE, with separate and unified heads,
    and its gradients against `jax.grad`, to 1e-5;
(c) three-step trajectories of `make_multi_task_train_step` against the
    JAX step with update_freq 2, layer decay 0.75 and no dropout or
    drop-path (separate heads under KL with the label-smoothing criterion,
    a unified head under CE): metrics to 2e-4 relative, final parameters as
    `tests/test_torch_train.py` holds them;
(d) the scene token's lr scale (the last layer's) and its decay flag
    (none), with every other parameter's, against JAX's
    `build_lr_scale_tree` and `build_wd_mask_tree`;
(e) the DP step (`dp_mesh=make_mesh()`, unified head) over two gloo ranks
    against the JAX step on the whole batch: the teacher pad's minimum is
    the global micro-batch's (`tests/_mt_dp_rank.py` is the ranks'
    program)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.losses import cross_entropy as jax_ce
from devias_tpu.losses import label_smoothing_cross_entropy as jax_ls_ce
from devias_tpu.losses import multi_task_loss as jax_multi_task_loss
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu.train import OptimConfig as JaxOptimConfig
from devias_tpu.train import TrainState as JaxTrainState
from devias_tpu.train import make_multi_task_train_step as jax_make_multi_task_train_step
from devias_tpu.train import make_optimizer as jax_make_optimizer
from devias_tpu.train.optim import build_lr_scale_tree, build_wd_mask_tree
from devias_tpu_torch.ckpt.from_jax import load_jax_params, param_name_map, state_dict_from_jax
from devias_tpu_torch.losses import cross_entropy, label_smoothing_cross_entropy, multi_task_loss
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import OptimConfig, TrainState, make_multi_task_train_step, make_optimizer

from _torch_parallel import run_ranks

SMALL = dict(depth=2, embed_dim=64, num_heads=4)
A, S = 5, 4  # action classes; scene classes (the teacher's head)
MT = dict(num_classes=A, num_scene_classes=S, **SMALL)
MT_DP_TIMEOUT = 70  # s: over three times the DP test's time under -n 6, 19.55 s
TEACHER = dict(num_classes=S, use_mean_pooling=False, **SMALL)
GEOM = dict(img_size=32, num_frames=4)
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=8, warmup_steps=2, layer_decay=0.75,
           weight_decay=0.05, weight_decay_end=0.1, num_layers=2)
ROOT = Path(__file__).resolve().parents[1]


def _flat(tree):
    return {tuple(getattr(k, "key", str(k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_params(name, seed, **kw):
    x = jnp.zeros((2, 4, 32, 32, 3), jnp.float32)
    model = jax_create_model(name, fused_attention=True, fused_interpret=True, **kw)
    params = model.init({"params": jax.random.PRNGKey(seed)}, x)["params"]
    rng = np.random.default_rng(seed)
    # heads of real size (the init scale makes them ~1e-5)
    return model, jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


def _port(name, kind, params, **kw):
    return load_jax_params(create_model(name, device="cpu", **kw), params, kind)


@pytest.mark.parametrize("learnable", [False, True])
@pytest.mark.parametrize("unified", [False, True])
def test_multi_task_vit_matches_flax(unified, learnable):
    kw = dict(MT, unified_head=unified, use_learnable_pos_emb=learnable)
    jm, params = _jax_params("disentangle_vit_base_patch16_224", 1, **kw)
    sd = state_dict_from_jax(params, "multi_task")
    assert ("scene_token" in sd, "pos_embed" in sd, "scene_head.weight" in sd) == (True, learnable, not unified)
    model = _port("disentangle_vit_base_patch16_224", "multi_task", params, **kw, **GEOM)
    x = np.random.default_rng(2).normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert set(got) == set(want)
    width = A + S if unified else A
    assert got["action_logit"].shape == (2, width) and got["scene_logit"].shape == (2, A + S if unified else S)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("unified", [False, True])
@pytest.mark.parametrize("criterion", ["KL", "CE"])
def test_multi_task_loss_and_grads_match(criterion, unified):
    rng = np.random.default_rng(3)
    width = A + S if unified else A
    action = rng.normal(size=(6, width)).astype(np.float32) * 2
    scene = rng.normal(size=(6, A + S if unified else S)).astype(np.float32) * 2
    teacher = rng.normal(size=(6, S)).astype(np.float32) * 3
    target = rng.integers(0, A, size=6)
    kw = dict(num_action_classes=A, logit_criterion=criterion, logit_criterion_weight=1.5, unified_head=unified)

    def theirs(a, s):
        total, _, parts = jax_multi_task_loss({"action_logit": a, "scene_logit": s}, jnp.asarray(teacher),
                                              jnp.asarray(target), action_criterion=jax_ls_ce, **kw)
        return total, parts

    (want, want_parts), want_grads = jax.value_and_grad(theirs, argnums=(0, 1), has_aux=True)(
        jnp.asarray(action), jnp.asarray(scene))
    a, s = (torch.from_numpy(v).requires_grad_(True) for v in (action, scene))
    total, logits, parts = multi_task_loss({"action_logit": a, "scene_logit": s}, torch.from_numpy(teacher),
                                           torch.from_numpy(target), action_criterion=label_smoothing_cross_entropy,
                                           **kw)
    total.backward()
    assert logits.shape == (6, width) and set(parts) == set(want_parts) == {"action_loss", "logit_loss"}
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-5)
    for k in parts:
        np.testing.assert_allclose(parts[k].item(), float(want_parts[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for got, w in zip((a.grad, s.grad), want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


CASES = {"separate_kl_smoothing": (False, "KL", lambda lg, lb: label_smoothing_cross_entropy(lg, lb, 0.1),
                                   lambda lg, lb: jax_ls_ce(lg, lb, 0.1)),
         "unified_ce": (True, "CE", cross_entropy, jax_ce)}


@pytest.mark.parametrize("case", list(CASES))
def test_multi_task_trajectory_matches_jax_step(case):
    unified, criterion, ours, theirs = CASES[case]
    U, B = 2, 4
    kw = dict(MT, unified_head=unified)
    jm, params = _jax_params("disentangle_vit_base_patch16_224", 4, **kw)
    jt, tparams = _jax_params("vit_base_patch16_224", 5, **TEACHER)
    tx, lr_fn = jax_make_optimizer(params, JaxOptimConfig(**OPT))
    state = JaxTrainState.create(params, tx)
    jstep = jax.jit(jax_make_multi_task_train_step(jm, jt, tx, A, criterion, 1.5, unified, theirs, U, lr_fn))

    model = _port("disentangle_vit_base_patch16_224", "multi_task", params, **kw, **GEOM)
    teacher = _port("vit_base_patch16_224", "plain", tparams, **TEACHER)
    opt, t_lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    t_state = TrainState.create(model, opt, device="cpu")
    tstep = make_multi_task_train_step(model, teacher, opt, A, criterion, 1.5, unified, ours, U, t_lr_fn,
                                       device="cpu")
    data = np.random.default_rng(6)
    key = jax.random.PRNGKey(7)
    for s in range(3):
        batch = {"videos": data.normal(size=(B, 4, 32, 32, 3)).astype(np.float32),
                 "labels": data.integers(0, A, size=B)}
        state, want = jstep(state, tparams, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        got = tstep(t_state, batch, host_metrics=True)
        assert set(got) == set(want) == {"loss", "action_loss", "logit_loss", "class_acc", "grad_norm", "lr"}
        for k in want:
            np.testing.assert_allclose(got[k], float(want[k]), rtol=2e-4, atol=1e-6, err_msg=f"step {s} {k}")
    final = state_dict_from_jax(jax.tree.map(np.asarray, state.params), "multi_task")
    lr_sum = sum(t_lr_fn(s) for s in range(3))
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), final[name]
        tol = 1e-5 + 3e-4 * np.abs(want).max()
        off = np.abs(got - want) > tol
        assert off.mean() <= 0.02, (name, off.mean())
        assert np.abs(got - want)[off].max(initial=0) <= 2 * lr_sum, name


def test_scene_token_groups_match_jax_trees():
    kw = dict(MT, use_learnable_pos_emb=True)
    _, params = _jax_params("disentangle_vit_base_patch16_224", 8, **kw)
    model = _port("disentangle_vit_base_patch16_224", "multi_task", params, **kw, **GEOM)
    opt, _ = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    jcfg = JaxOptimConfig(**OPT)
    scales, masks = _flat(build_lr_scale_tree(params, jcfg)), _flat(build_wd_mask_tree(params))
    paths = param_name_map("multi_task", 0, opt.names)
    assert sorted(paths.values()) == sorted(scales)
    for name, s, d in zip(opt.names, opt.scales, opt.decay):
        assert s == pytest.approx(scales[paths[name]]), name
        assert d == masks[paths[name]], name
    got = dict(zip(opt.names, zip(opt.scales, opt.decay)))
    # the reference's quirk: the scene token sits at the last layer id
    # (scale 1), the CLS token and the positions at layer 0; none decays
    assert got["scene_token"] == (pytest.approx(1.0), False)
    assert got["cls_token"] == got["pos_embed"] == (pytest.approx(0.75 ** 3), False)


def test_data_parallel_step_matches_jax_whole_batch(tmp_path):
    """Two gloo ranks, each holding half of every micro-batch (update_freq
    2, global batch 8), a unified head under KL, against the JAX step on
    the whole batch for two steps; the ranks bitwise equal."""
    from _mt_dp_rank import DP_OPT, U, B, STEPS, WORLD

    kw = dict(MT, unified_head=True)
    jm, params = _jax_params("disentangle_vit_base_patch16_224", 9, **kw)
    jt, tparams = _jax_params("vit_base_patch16_224", 10, **TEACHER)
    tx, lr_fn = jax_make_optimizer(params, JaxOptimConfig(**DP_OPT))
    jstep = jax.jit(jax_make_multi_task_train_step(jm, jt, tx, A, "KL", 1.0, True, jax_ce, U, lr_fn))
    data = np.random.default_rng(11)
    # teacher logits that differ in scale across the batch, so the global
    # minimum is not every half's own
    batches = []
    for s in range(STEPS):
        videos = data.normal(size=(B, 4, 32, 32, 3)).astype(np.float32)
        videos *= np.linspace(0.5, 3.0, B, dtype=np.float32)[:, None, None, None, None]
        batches.append({"videos": videos, "labels": data.integers(0, A, size=B)})
    torch.save({"init": state_dict_from_jax(params, "multi_task"), "teacher": state_dict_from_jax(tparams, "plain"),
                "batches": batches}, tmp_path / "ref.pt")

    def jax_steps(out, start):
        start()  # the ranks run meanwhile
        state, metrics = JaxTrainState.create(params, tx), []
        for batch in batches:
            state, m = jstep(state, tparams, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, state_dict_from_jax(jax.tree.map(np.asarray, state.params), "multi_task")

    (metrics, want), ranks = run_ranks(ROOT / "tests" / "_mt_dp_rank.py", tmp_path, jax_steps, WORLD,
                                       timeout=MT_DP_TIMEOUT)
    for got_metrics, final, lr_sum in ranks:
        for s, (m, w) in enumerate(zip(got_metrics, metrics)):
            assert set(m) == set(w)
            for k in w:
                np.testing.assert_allclose(m[k], w[k], rtol=2e-4, atol=1e-6, err_msg=f"step {s} {k}")
        for name, p in final.items():
            g, w = p.numpy(), want[name]
            tol = 1e-5 + 3e-4 * np.abs(w).max()
            off = np.abs(g - w) > tol
            assert off.mean() <= 0.02, (name, off.mean())
            assert np.abs(g - w)[off].max(initial=0) <= 2 * lr_sum, name
    assert ranks[1][0] == ranks[0][0]
    for name, p in ranks[1][1].items():
        torch.testing.assert_close(p, ranks[0][1][name], rtol=0, atol=0)


def test_pos_embed_surgery_keeps_the_cls_and_scene_rows(tmp_path):
    """A multi-task checkpoint with a learned pos-embed for 4x64x64 clips
    (CLS, 2 x 4 x 4 patches, scene token: 34 rows) into a model for
    4x32x32 clips (10 rows) through `--finetune`'s surgery: the CLS row
    and the scene row kept, the patch rows resized over the spatial grid
    (`interpolate_pos_embed`) frame by frame."""
    from devias_tpu_torch.ckpt import load_reference_checkpoint
    from devias_tpu_torch.ckpt.torch_import import interpolate_pos_embed

    kw = dict(MT, use_learnable_pos_emb=True, num_frames=4)
    src = create_model("disentangle_vit_base_patch16_224", device="cpu", seed=1, img_size=64, **kw)
    pth = str(tmp_path / "mt.pth")
    torch.save({"model": src.state_dict()}, pth)
    dst = create_model("disentangle_vit_base_patch16_224", device="cpu", seed=2, img_size=32, **kw)
    _, report = load_reference_checkpoint(dst, pth, "multi_task", expected_head_out=A, dst_spatial=2,
                                          frames_tokens=2)
    # the scene head (4 wide) is dropped by the head-width check, as the JAX
    # import drops it
    assert set(report["loaded"]) == set(dst.state_dict()) - {"scene_head.weight", "scene_head.bias"}
    assert report["unused_in_ckpt"] == []
    want, got = src.pos_embed.detach()[0], dst.pos_embed.detach()[0]
    assert want.shape[0] == 34 and got.shape[0] == 10
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[-1], want[-1], rtol=0, atol=0)
    torch.testing.assert_close(got[1:-1], interpolate_pos_embed(want[1:-1], 4, 2, 2), rtol=0, atol=0)
    torch.testing.assert_close(dst.scene_token, src.scene_token, rtol=0, atol=0)
