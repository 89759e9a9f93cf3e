"""The port's checkpoint converter (`devias_tpu_torch/cli/convert_checkpoint.py`)
against the JAX package's exporter, for the four model kinds at a small
size: a JAX model's params loaded into the port and saved as a port
checkpoint, `to_reference` of it equals `export_torch_state_dict` of the
same params key for key and bitwise (tied agg layers at every index), and
`to_port` of that file gives back the port model bitwise with every key
consumed. Also: the full-size slot layout in a DeepSpeed {'module': ...}
wrapper leaves no key unused, and the weights-only checkpoint loads
through `--finetune` but not as a train state."""

import jax
import numpy as np
import pytest
import torch

from devias_tpu.cli import convert_checkpoint as jax_convert
from devias_tpu.ckpt.torch_export import export_torch_state_dict
from devias_tpu_torch.ckpt import latest_checkpoint_step, load_checkpoint, load_jax_params, save_weights
from devias_tpu_torch.cli import convert_checkpoint

SMALL = ["--depth", "2", "--embed_dim", "64", "--num_heads", "4", "--num_frames", "4", "--input_size", "32",
         "--nb_classes", "5", "--num_scene_classes", "7", "--num_latents", "2", "--agg_depth", "3"]
CASES = [("slot", True), ("slot", False), ("plain", False), ("multi_task", False), ("slot_fusion", True)]


def _flags(kind, tie, extra=()):
    return ["--model_kind", kind, *SMALL, *(["--agg_weights_tie"] if tie else []), *extra]


@pytest.mark.parametrize("kind,tie", CASES, ids=[f"{k}-{'tied' if t else 'untied'}" for k, t in CASES])
def test_to_reference_equals_jax_export_and_to_port_round_trips(kind, tie, tmp_path):
    jargs = jax_convert.get_args(["to_torch", "--input", "x", "--output", "y", *_flags(kind, tie)])
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32) * 0.02,
                          jax_convert.build_template(jargs))
    want = export_torch_state_dict(params, kind, agg_depth=3)

    model = convert_checkpoint.build_template(convert_checkpoint.get_args(["to_port", "--input", "x", "--output", "y",
                                                                           *_flags(kind, tie)]))
    load_jax_params(model, params, kind)
    save_weights(str(tmp_path / "port"), 3, model.state_dict())
    ref = str(tmp_path / "ref.pth")
    convert_checkpoint.main(["to_reference", "--input", str(tmp_path / "port"), "--output", ref, *_flags(kind, tie)])
    obj = torch.load(ref, map_location="cpu", weights_only=True)
    assert set(obj) == {"model", "epoch"} and obj["epoch"] == 3
    got = obj["model"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)

    out = convert_checkpoint.main(["to_port", "--input", ref, "--output", str(tmp_path / "back"),
                                   *_flags(kind, tie)])
    assert not out["report"]["unused_in_ckpt"] and sorted(out["report"]["loaded"]) == sorted(want)
    assert latest_checkpoint_step(str(tmp_path / "back")) == 0
    back = torch.load(out["path"], map_location="cpu", weights_only=True)["model"]
    own = model.state_dict()
    assert sorted(back) == sorted(own)
    for k, v in own.items():
        assert torch.equal(back[k], v), k


def test_full_size_deepspeed_slot_layout_every_key_consumed(tmp_path):
    """The released checkpoint's layout: the full-size slot model (ViT-B,
    2 slots, 8 tied agg rounds, 400 + 365) in DeepSpeed's {'module': ...};
    the port's own model writes the state dict."""
    flags = ["--model_kind", "slot", "--nb_classes", "400", "--num_latents", "2", "--agg_depth", "8",
             "--agg_weights_tie"]
    args = convert_checkpoint.get_args(["to_port", "--input", "x", "--output", "y", *flags])
    net = convert_checkpoint.build_template(args)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.01)  # away from the template's seeded values
    sd = net.state_dict()
    pth = tmp_path / "released.pth"
    torch.save({"module": sd}, pth)
    out = convert_checkpoint.main(["to_port", "--input", str(pth), "--output", str(tmp_path / "port"), *flags])
    assert not out["report"]["unused_in_ckpt"]
    assert sorted(out["report"]["loaded"]) == sorted(sd)
    got = torch.load(out["path"], map_location="cpu", weights_only=True)["model"]
    assert torch.equal(got["head.weight"], sd["head.weight"])
    assert torch.equal(got["blocks.11.attn.qkv.weight"], sd["blocks.11.attn.qkv.weight"])
    assert torch.equal(got["agg_block.layers.7.0.fn.to_q.weight"], sd["agg_block.layers.0.0.fn.to_q.weight"])


def test_weights_only_checkpoint_is_not_a_train_state(tmp_path):
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.train import OptimConfig, TrainState, make_optimizer

    model = create_model("vit_base_patch16_224", device="cpu", depth=1, embed_dim=32, num_heads=2, num_classes=3)
    path = save_weights(str(tmp_path), 0, model.state_dict())
    opt, _ = make_optimizer(model, OptimConfig(), device="cpu")
    with pytest.raises(ValueError, match="--finetune"):
        load_checkpoint(path, TrainState.create(model, opt, device="cpu"))
