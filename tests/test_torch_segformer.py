"""The port's Segformer mask path against the JAX package's, in float32 on
the CPU at the tiny geometry of `tests/test_segformer.py` (four stages, sr
ratios > 1): the logits of the same params (atol 2e-4, rtol 1e-3, the
bound that file holds JAX to HF with), the person masks, the HF-layout
import (`strict=True`, from memory, a `.pth`, a snapshot directory and a
`.safetensors` file), `segformer_mix_sample` on the JAX call's draws
(atol 1e-6), and one slot train step with `segformer_apply` on a small
ViT against the JAX step, with the mix on the whole batch and shard-local
over two blocks (`num_data_shards=2`): metrics and each gradient within
the rtol 2e-4 of `tests/test_torch_train.py`, and the parameters after
the step as its trajectory test holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_draws import segformer_draws_from_key
from _segformer_weights import GEOMETRY, TINY
from _segformer_weights import hf_state_dict as _hf_dict
from devias_tpu.aug.fame import FAMEConfig as JaxFAMEConfig
from devias_tpu.aug.segformer_mix import segformer_frame_masks as jax_frame_masks
from devias_tpu.aug.segformer_mix import segformer_mix_sample as jax_mix
from devias_tpu.ckpt.segformer_import import import_segformer_params
from devias_tpu.losses import SlotLossConfig as JaxSlotLossConfig
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu.nn.segformer import Segformer as JaxSegformer
from devias_tpu.nn.segformer import SegformerConfig as JaxSegformerConfig
from devias_tpu.nn.segformer import person_masks as jax_person_masks
from devias_tpu.train import OptimConfig as JaxOptimConfig
from devias_tpu.train import TrainState as JaxTrainState
from devias_tpu.train import TrainStepConfig as JaxTrainStepConfig
from devias_tpu.train import make_optimizer as jax_make_optimizer
from devias_tpu.train import make_slot_train_step as jax_make_slot_train_step
from devias_tpu_torch.aug import FAMEConfig, segformer_frame_masks, segformer_mix_sample
from devias_tpu_torch.ckpt.from_jax import load_jax_params, segformer_state_dict_from_jax, state_dict_from_jax
from devias_tpu_torch.ckpt.segformer_import import load_segformer, load_state_dict
from devias_tpu_torch.losses import SlotLossConfig
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.nn.segformer import create_segformer, person_masks, segformer_b3
from devias_tpu_torch.train import OptimConfig, TrainState, TrainStepConfig, make_optimizer, make_slot_train_step

JAX_TINY = JaxSegformerConfig(**GEOMETRY)
# one compiled JAX forward for the tests that run it on two 64x64 frames
JAX_APPLY = jax.jit(JaxSegformer(JAX_TINY).apply)


def _jax_params(sd):
    """The JAX package's import of an HF-layout dict (numpy, no compile)."""
    return import_segformer_params(sd, JAX_TINY)


def _port(sd):
    return load_segformer(create_segformer(TINY, device="cpu"), sd)


def test_logits_match_jax():
    sd = _hf_dict()
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(JAX_APPLY({"params": _jax_params(sd)}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(sd)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 19)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_hf_layout_import(tmp_path):
    """The port's key layout is exactly what the JAX importer reads (each
    key, the BatchNorm's step counter aside), `segformer_state_dict_from_jax`
    maps the imported params back bitwise, and the dict loads into the
    port with `strict=True`, from memory and from each file form."""
    sd = _hf_dict(1)
    read = set()

    class Recording(dict):
        def __getitem__(self, k):
            read.add(k)
            return dict.__getitem__(self, k)

    back = segformer_state_dict_from_jax(import_segformer_params(Recording(sd), JAX_TINY), TINY)
    assert read == set(sd) - {"decode_head.batch_norm.num_batches_tracked"}
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    snapshot = tmp_path / "snapshot"
    snapshot.mkdir()
    torch.save(sd, snapshot / "pytorch_model.bin")
    torch.save(sd, tmp_path / "weights.pth")
    from safetensors.torch import save_file

    save_file(sd, str(tmp_path / "model.safetensors"))
    for source in (sd, str(snapshot), str(tmp_path / "weights.pth"), str(tmp_path / "model.safetensors")):
        loaded = load_segformer(create_segformer(TINY, device="cpu", seed=5), source).state_dict()
        for k, v in sd.items():
            assert torch.equal(loaded[k], v), (source if isinstance(source, str) else "dict", k)
    with pytest.raises(FileNotFoundError):
        load_state_dict(str(tmp_path / "empty"))


def test_b3_preset():
    cfg = segformer_b3()
    assert (cfg.depths, cfg.hidden_sizes, cfg.decoder_hidden_size) == ((3, 4, 18, 3), (64, 128, 320, 512), 768)


def test_person_masks_and_frame_masks_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 8, 8, 19)).astype(np.float32)
    np.testing.assert_array_equal(person_masks(torch.from_numpy(logits), (32, 32)).numpy(),
                                  np.asarray(jax_person_masks(jnp.asarray(logits), (32, 32))))
    sd = _hf_dict(2, person_bias=1.8)  # masks cover part of the frames
    params = _jax_params(sd)
    videos = rng.normal(size=(1, 4, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_frame_masks(lambda f: JAX_APPLY({"params": params}, f), jnp.asarray(videos)))
    got = segformer_frame_masks(_port(sd), torch.from_numpy(videos)).numpy()
    assert got.shape == (1, 2, 64, 64) and 0.05 < got.mean() < 0.95
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prob_aug", [0.5, 1.0])
def test_mix_sample_matches_jax_on_its_draws(prob_aug):
    B, T, H, W = 4, 8, 32, 48
    rng = np.random.default_rng(3)
    videos = rng.normal(size=(B, T, H, W, 3)).astype(np.float32)
    masks = (rng.random(size=(B, T // 2, H, W)) > 0.5).astype(np.float32)
    labels = np.arange(B)
    key = jax.random.PRNGKey(4)
    v, l, (fg, fgpf) = jax_mix(key, jnp.asarray(masks), jnp.asarray(videos), jnp.asarray(labels), prob_aug)
    draws = segformer_draws_from_key(key, B, T // 2, prob_aug)
    gv, gl, (gfg, gfgpf) = segformer_mix_sample(torch.from_numpy(masks), torch.from_numpy(videos),
                                                torch.from_numpy(labels), prob_aug, draws=draws)
    for got, want in ((gv, v), (gfg, fg), (gfgpf, fgpf)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(l))
    # without draws the generator supplies them
    out = segformer_mix_sample(torch.from_numpy(masks), torch.from_numpy(videos), torch.from_numpy(labels),
                               prob_aug, generator=torch.Generator().manual_seed(0))
    assert out[0].shape == (B, T, H, W, 3)


SMALL = dict(depth=2, embed_dim=64, num_heads=4)
SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=2, **SMALL)
TEACHER = dict(num_classes=4, use_mean_pooling=False, **SMALL)
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=8, warmup_steps=0, layer_decay=0.75,
           agg_block_scale=0.1, weight_decay=0.05)
# a bias every slot query shares cancels in the slot softmax: its true
# gradient is zero and both frameworks return rounding noise
ZERO_GRAD = ("agg_block.layers.0.0.norm.bias",)


def _vit_params(name, seed, **kw):
    model = jax_create_model(name, **kw)
    params = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, 4, 32, 32, 3)))["params"]
    rng = np.random.default_rng(seed)
    return model, jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


@pytest.mark.parametrize("shards", [1, 2])
def test_slot_step_with_segformer_matches_jax(shards):
    """One step of 4 clips (update_freq 1) with the Segformer mix
    (prob_aug 0.8), on one block or shard-local over two; the JAX step's
    mix draws are rebuilt from its key chain."""
    B, prob_aug = 4, 0.8
    seg_sd = _hf_dict(3, person_bias=0.85)
    seg_params = _jax_params(seg_sd)
    jseg = JaxSegformer(JAX_TINY)
    jm, params = _vit_params("slot_vit_base_patch16_224", 5, **SLOT)
    jt, tparams = _vit_params("vit_base_patch16_224", 6, **TEACHER)
    tx, lr_fn = jax_make_optimizer(params, JaxOptimConfig(**OPT))
    state = JaxTrainState.create(params, tx)
    jcfg = JaxTrainStepConfig(use_fame=False, fame=JaxFAMEConfig(prob_aug=prob_aug), num_data_shards=shards)
    jstep = jax.jit(jax_make_slot_train_step(jm, jt, tx, JaxSlotLossConfig(5, 4), jcfg, lr_fn,
                                             segformer_apply=lambda f: jseg.apply({"params": seg_params}, f)))

    model = load_jax_params(create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **SLOT), params,
                            "slot")
    teacher = load_jax_params(create_model("vit_base_patch16_224", device="cpu", **TEACHER), tparams, "plain")
    opt, t_lr_fn = make_optimizer(model, OptimConfig(**OPT), device="cpu")
    t_state = TrainState.create(model, opt, device="cpu")
    tcfg = TrainStepConfig(use_fame=False, fame=FAMEConfig(prob_aug=prob_aug), num_data_shards=shards)
    tstep = make_slot_train_step(model, teacher, opt, SlotLossConfig(5, 4), tcfg, t_lr_fn,
                                 segformer_apply=_port(seg_sd), device="cpu")

    data = np.random.default_rng(7)
    batch = {"videos": data.normal(size=(B, 4, 32, 32, 3)).astype(np.float32), "labels": data.integers(0, 5, size=B)}
    key = jax.random.PRNGKey(8)
    state, want = jstep(state, tparams, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    mix_key = jax.random.split(jax.random.split(jax.random.fold_in(key, 0), 1)[0], 3)[0]
    keys = jax.random.split(mix_key, shards) if shards > 1 else [mix_key]
    draws = [segformer_draws_from_key(k, B // shards, 2, prob_aug) for k in keys]
    got = tstep(t_state, batch, draws=[draws] if shards > 1 else draws[0], host_metrics=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=2e-4, atol=1e-6, err_msg=k)
    assert want["mask_distill_loss"] > 0
    # each gradient, from the first step's Adam moment m = (1 - beta1) g
    beta1 = JaxOptimConfig().beta1
    jmu = state_dict_from_jax(jax.tree.map(np.asarray, state.opt_state.mu), "slot", 2)
    final = state_dict_from_jax(jax.tree.map(np.asarray, state.params), "slot", 2)
    lr_sum = t_lr_fn(0)
    for name, p in model.named_parameters():
        if name not in ZERO_GRAD:
            g_want = jmu[name] / (1 - beta1)
            g_got = opt.state[p]["exp_avg"].numpy() / (1 - beta1)
            np.testing.assert_allclose(g_got, g_want, rtol=2e-4, atol=2e-4 * np.abs(g_want).max(), err_msg=name)
        got, want = p.detach().numpy(), final[name]
        tol = 1e-5 + 3e-4 * np.abs(want).max()
        off = np.abs(got - want) > tol
        assert name in ZERO_GRAD or off.mean() <= 0.02, (name, off.mean())
        assert np.abs(got - want)[off].max(initial=0) <= 2 * lr_sum, name


def test_device_normalize_feeds_the_mask_model_normalized_clips():
    """Under `device_normalize` the step's [0, 1] clips reach the mask model
    ImageNet-normalized, every other frame, as the JAX step feeds it; the
    mix itself takes the [0, 1] clips."""
    from devias_tpu_torch.aug.fame import IMAGENET_MEAN, IMAGENET_STD
    from devias_tpu_torch.train.step import mix_clips

    seen = []

    def apply(frames):
        seen.append(frames.clone())
        return torch.zeros(frames.shape[0], 8, 8, 19)  # argmax 0: no person, the clips pass unmixed

    videos = torch.rand(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    draws = {"perm": torch.tensor([1, 0]), "keep": torch.tensor([True, True]), "frame": torch.tensor(1)}
    out, _, fg, fg_pf = mix_clips(videos, torch.tensor([0, 1]),
                                  TrainStepConfig(use_fame=False, device_normalize=True), draws=draws,
                                  segformer_apply=apply)
    want = ((videos - torch.tensor(IMAGENET_MEAN)) / torch.tensor(IMAGENET_STD))[:, ::2].reshape(4, 32, 32, 3)
    assert len(seen) == 1
    torch.testing.assert_close(seen[0], want, rtol=0, atol=0)
    torch.testing.assert_close(out, videos[[1, 0]], rtol=0, atol=0)
    assert fg.shape == (2, 4) and fg_pf.shape == (2, 8) and not fg.any() and not fg_pf.any()
