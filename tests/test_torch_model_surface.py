"""The port's model constructors and the new options' weights against the
JAX package, in float32 at a small size (width 64, 4 heads, depth 2,
2 x 4 x 32 x 32 clips):

- the constructor surface: for every registry name (and `VideoViT`,
  `Block`, `Attention`, `AggregationBlock`), every field of the JAX
  module is a parameter of the port's constructor, except the fields named
  in `LEFT_OUT` with their reason; `create_model` builds each registry
  model with JAX's default of every such field;
- a reference checkpoint with LayerScale (`blocks.{i}.gamma_*`, written by
  JAX's `export_torch_state_dict`) through `import_torch_state_dict` and
  `merge_params`: every key loaded, the values those of
  `state_dict_from_jax`; without LayerScale the gammas stay unused;
- `param_name_map` of `gamma_*` and `pos_embed`, and the layer-decay lr
  scale and weight-decay flag of every parameter of a LayerScale model
  with a learned `pos_embed`, against `build_lr_scale_tree` and
  `build_wd_mask_tree`;
- the int8 student (`SlotViT(int8_dense=True)`) against JAX's, as
  `tests/test_torch_quant.py` holds the int8 teacher."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from devias_tpu.ckpt.torch_export import export_torch_state_dict
from devias_tpu.nn import create_model as jax_create_model
from devias_tpu.nn import models as jmodels
from devias_tpu.nn import vit as jvit
from devias_tpu.nn.agg import AggregationBlock as JaxAggregationBlock
from devias_tpu.train import OptimConfig as JaxOptimConfig
from devias_tpu.train.optim import build_lr_scale_tree, build_wd_mask_tree
from devias_tpu_torch.ckpt.from_jax import load_jax_params, param_name_map, state_dict_from_jax
from devias_tpu_torch.ckpt.torch_import import import_torch_state_dict, merge_params
from devias_tpu_torch.nn import AggregationBlock, create_model
from devias_tpu_torch.nn import models as tmodels
from devias_tpu_torch.nn import vit as tvit
from devias_tpu_torch.train import OptimConfig, make_optimizer

TINY = dict(depth=2, embed_dim=64, num_heads=4)
SLOT = dict(num_classes=5, num_scene_classes=3, num_latents=2, agg_depth=2, **TINY)
CLIPS = (2, 4, 32, 32, 3)

# JAX fields the port's constructors do not take, and why
LEFT_OUT = {
    "fused_interpret": "runs the Pallas kernels in the interpreter; the port's kernels take CPU tensors "
                       "through their plain versions instead",
    "patch_embed_conv": "chooses between two lowerings of the same linear map (devias_tpu/nn/vit.py:387); "
                        "the port has one, and patch_embed_mode names the same choice",
    "seq_axis": "the shard_map axis of sequence parallelism; the port passes an SPMesh to forward "
                "(core/dist.py)",
    "seq_shards": "the size of that axis; the SPMesh carries it",
    "fused": "the agg block's, unused in JAX (devias_tpu/nn/agg.py:558-561)",
}
JAX_PORT = [
    (jmodels.SlotViT, tmodels.SlotViT), (jmodels.PlainViT, tmodels.PlainViT),
    (jmodels.MultiTaskViT, tmodels.MultiTaskViT), (jmodels.SlotFusionViT, tmodels.SlotFusionViT),
    (jvit.VideoViT, tvit.VideoViT), (jvit.Block, tvit.Block), (jvit.Attention, tvit.Attention),
    (JaxAggregationBlock, AggregationBlock),
]


def _fields(cls):
    return {f.name: f.default for f in dataclasses.fields(cls) if f.name not in ("parent", "name")}


@pytest.mark.parametrize("jax_cls, port_cls", JAX_PORT, ids=[j.__name__ for j, _ in JAX_PORT])
def test_every_jax_field_is_a_port_parameter(jax_cls, port_cls):
    params = inspect.signature(port_cls.__init__).parameters
    missing = sorted(f for f in _fields(jax_cls) if f not in params and f not in LEFT_OUT)
    assert not missing, f"{port_cls.__name__} lacks {missing}"


@pytest.mark.parametrize("name", sorted(tmodels._REGISTRY))
def test_create_model_takes_every_jax_field(name):
    """The registry model built with JAX's default of each field it has
    (dtype as torch's float32), at a tiny width."""
    fields = _fields(jmodels._REGISTRY[name])
    kw = {f: v for f, v in fields.items() if f not in LEFT_OUT and f != "dtype" and f not in TINY}
    model = create_model(name, device="cpu", **kw, **TINY)
    assert len(model.blocks) == TINY["depth"]


def _jitter(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)


def _slot_params(seed, **kw):
    jm = jax_create_model("slot_vit_base_patch16_224", **SLOT, **kw)
    x = jnp.asarray(np.random.default_rng(seed).normal(size=CLIPS).astype(np.float32))
    return jm, _jitter(jax.jit(jm.init)({"params": jax.random.PRNGKey(seed)}, x)["params"], seed), x


def test_reference_gammas_load_through_merge_params():
    _, params, _ = _slot_params(0, init_values=0.1)
    ref = {k: torch.from_numpy(np.array(v)) for k, v in export_torch_state_dict(params, "slot", 2).items()}
    gammas = {f"blocks.{i}.gamma_{j}" for i in range(2) for j in (1, 2)}
    assert gammas <= set(ref)
    model = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, init_values=0.1, **SLOT)
    report = merge_params(model, import_torch_state_dict(ref, "slot", agg_depth=2))
    assert not report["unused_in_ckpt"] and gammas <= set(report["loaded"])
    want = state_dict_from_jax(params, "slot", 2)
    assert set(model.state_dict()) == set(want)
    for k, v in model.state_dict().items():
        assert np.array_equal(v.numpy(), want[k]), k

    plain = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **SLOT)
    report = merge_params(plain, import_torch_state_dict(ref, "slot", agg_depth=2))
    assert sorted(report["unused_in_ckpt"]) == sorted(gammas)


def _flat(tree):
    return {tuple(getattr(p, "key", str(p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_lr_scales_and_decay_flags_of_gammas_and_pos_embed_match_jax():
    kw = dict(init_values=0.1, use_learnable_pos_emb=True)
    _, params, _ = _slot_params(1, **kw)
    model = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, num_frames=4, **kw, **SLOT)
    load_jax_params(model, params, "slot")
    cfg = dict(lr=1e-3, layer_decay=0.75, num_layers=2, agg_block_scale=0.1, weight_decay=0.05)
    opt, _ = make_optimizer(model, OptimConfig(**cfg), device="cpu")
    scales = _flat(build_lr_scale_tree(params, JaxOptimConfig(**cfg)))
    masks = _flat(build_wd_mask_tree(params))
    paths = param_name_map("slot", 2, opt.names)
    assert sorted(paths.values()) == sorted(scales)
    assert paths["blocks.1.gamma_2"] == ("backbone", "blocks_1", "gamma_2")
    assert paths["pos_embed"] == ("backbone", "pos_embed")
    for name, s, d in zip(opt.names, opt.scales, opt.decay):
        assert s == pytest.approx(scales[paths[name]]), name
        assert d == bool(masks[paths[name]]), name
    named = dict(zip(opt.names, zip(opt.scales, opt.decay)))
    assert named["blocks.0.gamma_1"] == (pytest.approx(0.75 ** 2), False)
    assert named["pos_embed"] == (pytest.approx(0.75 ** 3), False)


def test_int8_student_matches_jax():
    """The w8a8 student's slot logits against JAX's `int8_dense` student
    within 1e-3 of their largest magnitude, and near the float32 student's."""
    j8, params, x = _slot_params(2, int8_dense=True)
    # a sharper head than the init's, so the logits have a spread
    params = dict(params, head=jax.tree.map(
        lambda a: np.random.default_rng(3).normal(size=a.shape).astype(np.float32) * 0.5, params["head"]))
    want = np.asarray(j8.apply({"params": params}, x)["slots_head"])
    t8 = load_jax_params(create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, int8_dense=True,
                                      **SLOT), params, "slot")
    t32 = load_jax_params(create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **SLOT),
                          params, "slot")
    assert all(m.int8_dense for n, m in t8.named_modules() if n.endswith(("attn.qkv", "attn.proj", "fc1", "fc2"))
               and n.startswith("blocks"))
    assert not t8.head.int8_dense and not t8.agg_block.layers[0][0].fn.to_q.int8_dense
    xt = torch.from_numpy(np.asarray(x))
    with torch.no_grad():
        got = t8(xt)["slots_head"].numpy()
        ref = t32(xt)["slots_head"].numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-3 * scale, (np.abs(got - want).max(), scale)
    cos = (got * ref).sum() / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert cos >= 0.99, cos
