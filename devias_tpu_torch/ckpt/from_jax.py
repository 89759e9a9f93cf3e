"""Weights from a `devias_tpu` flax parameter tree into the port.

`state_dict_from_jax` maps a flax param tree (numpy arrays, or anything
`np.asarray` takes) to the reference-layout state dict the port's modules
carry: Dense kernels [in, out] become Linear weights [out, in], LayerNorm
scale becomes weight, the patch-embed kernel [t*p*p*C, D] becomes the
Conv3d layout [D, C, t, p, p], and a tied agg block's one unique layer is
written at every round index. `load_jax_params` loads it with
`strict=True`. `param_name_map` names the flax path of each port
parameter, so per-parameter rules (lr scales, decay masks) and values can
be held against the JAX trees. The kinds are the four model families:
`slot` (SlotViT), `plain` (PlainViT), `multi_task` (MultiTaskViT, whose
flax `suffix_tokens` is the port's `scene_token`) and `slot_fusion`
(SlotFusionViT).

`segformer_state_dict_from_jax` maps a flax `Segformer` param tree to the
HuggingFace layout the port's `nn/segformer.py` carries (the inverse of
`devias_tpu/ckpt/segformer_import.py`): conv kernels HWIO become OIHW.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

MODEL_KINDS = ("slot", "plain", "multi_task", "slot_fusion")


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _linear(sd, name, tree):
    sd[f"{name}.weight"] = _np(tree["kernel"]).T.copy()
    if "bias" in tree:
        sd[f"{name}.bias"] = _np(tree["bias"]).copy()


def _ln(sd, name, tree):
    sd[f"{name}.weight"] = _np(tree["scale"]).copy()
    sd[f"{name}.bias"] = _np(tree["bias"]).copy()


def backbone_from_jax(sd: Dict[str, np.ndarray], bb: Dict[str, Any]) -> None:
    """Write a VideoViT param tree (16x16 RGB patches) into `sd` under the
    reference keys."""
    k = _np(bb["patch_embed"]["kernel"])  # [t*p*p*C, D]
    p, c = 16, 3
    sd["patch_embed.proj.weight"] = k.reshape(-1, p, p, c, k.shape[1]).transpose(4, 3, 0, 1, 2).copy()
    sd["patch_embed.proj.bias"] = _np(bb["patch_embed"]["bias"]).copy()
    if "cls_token" in bb:
        sd["cls_token"] = _np(bb["cls_token"]).copy()
    if "suffix_tokens" in bb:
        sd["scene_token"] = _np(bb["suffix_tokens"]).copy()
    if "pos_embed" in bb:
        sd["pos_embed"] = _np(bb["pos_embed"]).copy()
    i = 0
    while f"blocks_{i}" in bb:
        blk, b = bb[f"blocks_{i}"], f"blocks.{i}"
        _ln(sd, f"{b}.norm1", blk["norm1"])
        _ln(sd, f"{b}.norm2", blk["norm2"])
        sd[f"{b}.attn.qkv.weight"] = _np(blk["attn"]["qkv_kernel"]).T.copy()
        sd[f"{b}.attn.q_bias"] = _np(blk["attn"]["q_bias"]).copy()
        sd[f"{b}.attn.v_bias"] = _np(blk["attn"]["v_bias"]).copy()
        _linear(sd, f"{b}.attn.proj", blk["attn"]["proj"])
        _linear(sd, f"{b}.mlp.fc1", blk["mlp"]["fc1"])
        _linear(sd, f"{b}.mlp.fc2", blk["mlp"]["fc2"])
        i += 1
    if "norm" in bb:
        _ln(sd, "norm", bb["norm"])


def agg_from_jax(sd: Dict[str, np.ndarray], agg: Dict[str, Any], depth: int,
                 prefix: str = "agg_block.") -> None:
    """Write an AggregationBlock param tree into `sd`; a tied block's
    unique layer goes to every one of the `depth` round indices."""
    sd[f"{prefix}latents"] = _np(agg["latents"]).copy()
    unique = sorted(int(n.split("_")[1]) for n in agg if n.startswith("layers_"))
    for i in range(depth):
        lay = agg[f"layers_{unique[min(i, len(unique) - 1)]}"]
        b = f"{prefix}layers.{i}"
        _ln(sd, f"{b}.0.norm", lay["norm_q"])
        _ln(sd, f"{b}.0.norm_context", lay["norm_context"])
        for name in ("to_q", "to_k", "to_v"):
            sd[f"{b}.0.fn.{name}.weight"] = _np(lay["cross_attn"][name]["kernel"]).T.copy()
        _linear(sd, f"{b}.0.fn.to_out.0", lay["cross_attn"]["to_out"])
        _ln(sd, f"{b}.2.norm", lay["norm_ff"])
        _linear(sd, f"{b}.2.fn.net.0", lay["ff_fc1"])
        _linear(sd, f"{b}.2.fn.net.3", lay["ff_fc2"])
    _ln(sd, f"{prefix}last_layer.0", agg["last_norm"])


_REQUIRED = {"slot": ("head", "agg_block", "mask_predictor"), "plain": ("head",), "multi_task": ("head",),
             "slot_fusion": ("fusion_head", "action_norm")}


def _check_kind(model_kind: str) -> None:
    if model_kind not in MODEL_KINDS:
        raise ValueError(f"unknown model_kind {model_kind!r}; expected one of {MODEL_KINDS}")


def state_dict_from_jax(params: Dict[str, Any], model_kind: str, agg_depth: int = 8) -> Dict[str, np.ndarray]:
    """Reference-layout state dict of a flax param tree of `model_kind`
    (`MODEL_KINDS`); `agg_depth` is the number of agg rounds of a model
    with an agg block."""
    _check_kind(model_kind)
    missing = [k for k in ("backbone", *_REQUIRED[model_kind]) if k not in params]
    if missing:
        raise ValueError(f"{model_kind} params lack {missing}; have {sorted(params)}")
    sd: Dict[str, np.ndarray] = {}
    backbone_from_jax(sd, params["backbone"])
    if "agg_block" in params:
        agg_from_jax(sd, params["agg_block"], agg_depth)
    if model_kind == "slot":
        for name, idx in (("fc1", 0), ("fc2", 2), ("fc3", 4)):
            _linear(sd, f"mask_predictor.decoder.{idx}", params["mask_predictor"][name])
    for name in ("fc_norm", "action_norm", "scene_norm"):
        if name in params:
            _ln(sd, name, params[name])
    if "head" in params:
        if "fc1" in params["head"]:  # MLP head
            _linear(sd, "head.fc1", params["head"]["fc1"])
            _linear(sd, "head.fc2", params["head"]["fc2"])
        else:
            _linear(sd, "head", params["head"])
    if "scene_head" in params:
        _linear(sd, "scene_head", params["scene_head"])
    fh = params.get("fusion_head")
    if fh is not None and "classifier" in fh:  # FusionMLPHead
        for name, sub in fh.items():
            (_ln if name.endswith("_ln") else _linear)(sd, f"fusion_head.{name}", sub)
    elif fh is not None:
        _linear(sd, "fusion_head", fh)
    return sd


def load_jax_params(model: nn.Module, params: Dict[str, Any], model_kind: str,
                    agg_depth: Optional[int] = None) -> nn.Module:
    """Load a flax param tree into `model` with `strict=True`. `agg_depth`
    defaults to the model's own number of agg rounds."""
    if agg_depth is None:
        agg = getattr(model, "agg_block", None)
        agg_depth = agg.depth if agg is not None else 0
    sd = state_dict_from_jax(params, model_kind, agg_depth)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()},
                          strict=True)
    return model


_LN_MODULES = ("norm1", "norm2", "norm", "norm_context", "fc_norm", "action_norm", "scene_norm")
_AGG_MODULES = {("0", "norm"): ("norm_q",), ("0", "norm_context"): ("norm_context",),
                ("0", "fn", "to_q"): ("cross_attn", "to_q"), ("0", "fn", "to_k"): ("cross_attn", "to_k"),
                ("0", "fn", "to_v"): ("cross_attn", "to_v"), ("0", "fn", "to_out", "0"): ("cross_attn", "to_out"),
                ("2", "norm"): ("norm_ff",), ("2", "fn", "net", "0"): ("ff_fc1",),
                ("2", "fn", "net", "3"): ("ff_fc2",)}
_DECODER = {"0": "fc1", "2": "fc2", "4": "fc3"}


def _leaf(module: Tuple[str, ...], leaf: str, norm: bool) -> Tuple[str, ...]:
    if leaf == "weight":
        return module + ("scale" if norm else "kernel",)
    return module + (leaf,)


def flax_path(name: str, model_kind: str, agg_weights_tie: bool = True) -> Tuple[str, ...]:
    """The flax param path of the port parameter `name` of a model of
    `model_kind`."""
    _check_kind(model_kind)
    *mod, leaf = name.split(".")
    if mod[:1] == ["patch_embed"]:
        return ("backbone", "patch_embed", "kernel" if leaf == "weight" else leaf)
    if not mod and leaf in ("cls_token", "pos_embed"):
        return ("backbone", leaf)
    if not mod and leaf == "scene_token":
        return ("backbone", "suffix_tokens")
    if mod[:1] == ["blocks"]:
        block = ("backbone", f"blocks_{mod[1]}")
        rest = tuple(mod[2:])
        if rest == ("attn", "qkv"):
            return block + ("attn", "qkv_kernel")
        if rest == ("attn",):
            return block + ("attn", leaf)
        return _leaf(block + rest, leaf, rest[-1] in _LN_MODULES)
    if mod == ["norm"]:
        return _leaf(("backbone", "norm"), leaf, True)
    if mod[:1] == ["agg_block"]:
        if leaf == "latents":
            return ("agg_block", "latents")
        if mod[1] == "last_layer":
            return _leaf(("agg_block", "last_norm"), leaf, True)
        layer = ("agg_block", f"layers_{0 if agg_weights_tie else int(mod[2])}")
        sub = _AGG_MODULES[tuple(mod[3:])]
        return _leaf(layer + sub, leaf, "norm" in sub[-1])
    if mod[:2] == ["mask_predictor", "decoder"]:
        return _leaf(("mask_predictor", _DECODER[mod[2]]), leaf, False)
    if len(mod) == 1 and mod[0] in _LN_MODULES:
        return _leaf(tuple(mod), leaf, True)
    if mod[:1] in (["head"], ["scene_head"]):
        return _leaf(tuple(mod), leaf, False)
    if mod[:1] == ["fusion_head"]:
        return _leaf(tuple(mod), leaf, mod[-1].endswith("_ln"))
    raise ValueError(f"no flax path for port parameter {name!r}")


def param_name_map(model_kind: str, agg_depth: int, names: Iterable[str],
                   agg_weights_tie: bool = True) -> Dict[str, Tuple[str, ...]]:
    """Port parameter name -> flax param path for `names` (a model's
    `named_parameters()` or `state_dict()` keys). A tied agg block maps
    every round index to its one flax layer; `agg_depth` bounds the round
    indices."""
    out = {}
    for name in names:
        parts = name.split(".")
        if parts[:2] == ["agg_block", "layers"] and int(parts[2]) >= agg_depth:
            raise ValueError(f"{name}: round index beyond agg_depth {agg_depth}")
        out[name] = flax_path(name, model_kind, agg_weights_tie)
    return out


def _conv(sd, name, tree):
    sd[f"{name}.weight"] = _np(tree["kernel"]).transpose(3, 2, 0, 1).copy()
    if "bias" in tree:
        sd[f"{name}.bias"] = _np(tree["bias"]).copy()


def segformer_state_dict_from_jax(params: Dict[str, Any], config) -> Dict[str, np.ndarray]:
    """HF-layout state dict of a flax `Segformer` param tree of geometry
    `config` (a `SegformerConfig` of either package)."""
    sd: Dict[str, np.ndarray] = {}
    e = "segformer.encoder"
    for s in range(4):
        _conv(sd, f"{e}.patch_embeddings.{s}.proj", params[f"patch_embed_{s}_proj"])
        _ln(sd, f"{e}.patch_embeddings.{s}.layer_norm", params[f"patch_embed_{s}_norm"])
        for i in range(config.depths[s]):
            blk, b = params[f"block_{s}_{i}"], f"{e}.block.{s}.{i}"
            _ln(sd, f"{b}.layer_norm_1", blk["norm1"])
            for name, sub in (("query", "q"), ("key", "k"), ("value", "v")):
                _linear(sd, f"{b}.attention.self.{name}", blk["attn"][sub])
            if "sr" in blk["attn"]:
                _conv(sd, f"{b}.attention.self.sr", blk["attn"]["sr"])
                _ln(sd, f"{b}.attention.self.layer_norm", blk["attn"]["sr_norm"])
            _linear(sd, f"{b}.attention.output.dense", blk["attn"]["proj"])
            _ln(sd, f"{b}.layer_norm_2", blk["norm2"])
            _linear(sd, f"{b}.mlp.dense1", blk["mlp"]["dense1"])
            _conv(sd, f"{b}.mlp.dwconv.dwconv", blk["mlp"]["dwconv"])
            _linear(sd, f"{b}.mlp.dense2", blk["mlp"]["dense2"])
        _ln(sd, f"{e}.layer_norm.{s}", params[f"stage_norm_{s}"])
        _linear(sd, f"decode_head.linear_c.{s}.proj", params[f"linear_c_{s}"])
    _conv(sd, "decode_head.linear_fuse", params["linear_fuse"])
    bn = params["bn"]
    for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var")):
        sd[f"decode_head.batch_norm.{ours}"] = _np(bn[theirs]).copy()
    sd["decode_head.batch_norm.num_batches_tracked"] = np.asarray(0, np.int64)
    _conv(sd, "decode_head.classifier", params["classifier"])
    return sd
