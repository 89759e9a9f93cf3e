"""The slot train step with the SegFormer mask model in FAME's place
(`--mask_model Segformer`): `make_slot_train_step(..., segformer_apply=)`
with the configuration's `mask_model`, frozen, on the even frames of each
clip, then the mix with FAME's `prob_aug`, the teacher, the student's
forward and backward, the slot loss and AdamW, as `slot_train` drives
the FAME step (`TrainEntry`), with each pool batch's `frame` drawn too.

The mask model's weights come from the seed on a stream of this entry's
own, by `harness/weights.py`'s rule. On random weights the person class
is arbitrary, so its classifier bias is raised until about SEG_SHARE of
the quarter-resolution pixels of pool batch 0's even frames take it, the
raise computed once by the float32 reference and written into the weights
both sides load: the mix and the mask losses then have person and
background pixels to work on.

The check adds the mask model to the train step's: before the program is
freed its own mask module runs on the checked batches' even frames
(`segformer_frame_masks`, keeping the logits). `mask_logit_gap`: the
largest difference of those logits from the reference's float32 ones over
the reference logits' standard deviation. `mask_gap`: the share of pixels
whose masks differ, among those whose reference person-over-best-other
margin lies TIE_SIGMAS standard deviations or more from 0;
`mask_tie_share`: the share nearer than that (reported). Near-tie pixels
take the program's mask in the reference step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from harness import spec
from harness.entries import (CHECKED_STEPS, DROP_STREAM, REF_ROWS, TrainEntry, judge, reference_precision,
                             train_gaps)
from harness.weights import generator, load_into, make_weights, shapes_of
from reference import model as ref_model
from reference import segformer as ref_segformer
from reference import segformer_train as ref_seg_train

# this entry's streams of the seed (harness/weights.py holds 1-4)
MASK_WEIGHT_STREAM, FRAME_STREAM = 5, 6
# the share of pixels the raised person bias aims at
SEG_SHARE = 0.3
# frames the reference SegFormer runs at once
REF_FRAMES = 24
# the tie margin of the masks, in standard deviations of the reference
# logits: twice the limit of `mask_logit_gap`, since a person-over-best-other
# margin is the difference of two logits, each within that limit of the
# reference's in a sound run, so no pixel outside it can flip by rounding
TIE_SIGMAS = 0.4
FAULTS = ("odd_frames", "no_mask")


def mask_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The mask model's weights from the seed: `harness/weights.py`'s rule
    (1 + 0.02 z for 1-D weights, 0.02 z for everything else) on this
    entry's stream."""
    with torch.device("meta"):
        shapes = shapes_of(spec.model(m["name"]).reference(m).named_parameters())
    names = sorted(shapes)
    sizes = [torch.Size(shapes[n]).numel() for n in names]
    flat = torch.randn(sum(sizes), generator=generator(seed, MASK_WEIGHT_STREAM, device), device=device)
    out = {}
    for n, z in zip(names, torch.split(flat, sizes)):
        z = z.view(shapes[n])
        out[n] = 1.0 + 0.02 * z if len(shapes[n]) == 1 and n.endswith("weight") else 0.02 * z
    return out


def even_frames(videos: torch.Tensor, odd: bool = False) -> torch.Tensor:
    """[B, T, H, W, C] -> the frames the mask model sees, [B T/2, H, W, C]
    (with `odd`, the other half: a planted fault)."""
    B, T, H, W, C = videos.shape
    return videos[:, int(odd)::2].reshape(B * (T // 2), H, W, C)


@torch.no_grad()
def reference_logits(seg, frames: torch.Tensor) -> torch.Tensor:
    return torch.cat([seg(frames[i:i + REF_FRAMES]) for i in range(0, frames.shape[0], REF_FRAMES)])


def mask_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The mask model's numbers (module docstring) of `prog`'s logits and
    masks against the reference's logits and margins."""
    sigma = ref["sigma"]
    logit_gap = max(float((p - r).abs().max()) for p, r in zip(prog["logits"], ref["logits"])) / sigma
    differ = sure = ties = total = 0
    for masks, margin in zip(prog["masks"], ref["margin"]):
        tie = margin.abs() < TIE_SIGMAS * sigma
        differ += int(((masks != (margin > 0)) & ~tie).sum())
        sure += int((~tie).sum())
        ties += int(tie.sum())
        total += tie.numel()
    return {"mask_logit_gap": logit_gap, "mask_gap": differ / max(sure, 1), "mask_tie_share": ties / total}


class SegformerTrainEntry(TrainEntry):
    """`TrainEntry`'s slot step with the mask model (module docstring)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from devias_tpu_torch.aug import FAMEConfig
        from devias_tpu_torch.losses import SlotLossConfig
        from devias_tpu_torch.train import TrainStepConfig, make_slot_train_step

        super().__init__(cfg, traffic, seed, device, hvu=False)
        m, mm = cfg["model"], cfg["mask_model"]
        self.person = mm["person_class"]
        g = generator(seed, FRAME_STREAM, self.device)
        self.pool["frame"] = torch.randint(0, m["num_frames"] // 2, (traffic["pool"],), generator=g,
                                           device=self.device)
        weights = mask_weights(mm, seed, self.device)
        self.person_raise = self._raise(weights)
        weights["decode_head.classifier.bias"][self.person] += self.person_raise
        self.seg = spec.model(mm["name"]).program(mm, self.device)
        load_into(self.seg, weights)
        del weights
        loss_cfg = SlotLossConfig(num_action_classes=m["num_classes"], num_scene_classes=m["num_scene_classes"],
                                  **cfg["loss"])
        step_cfg = TrainStepConfig(use_fame=False, fame=FAMEConfig(beta=cfg["fame"]["beta"],
                                                                   prob_aug=cfg["fame"]["prob_aug"]))
        self.step = make_slot_train_step(self.model, self.teacher, self.opt, loss_cfg, step_cfg, self.opt.lr_fn,
                                         segformer_apply=self.seg, device=self.device)

    def reference_segformer(self, weights: Dict[str, torch.Tensor], quant: Optional[str] = None):
        mm = self.cfg["mask_model"]
        seg = spec.model(mm["name"]).reference(mm).to(self.device).eval()
        load_into(seg, weights)
        ref_segformer.set_quant(seg, quant)
        return seg.requires_grad_(False)

    def _raise(self, weights: Dict[str, torch.Tensor]) -> float:
        """The raise of the person bias that makes SEG_SHARE of the
        quarter-resolution pixels of pool batch 0's even frames take the
        person class under the float32 reference."""
        with reference_precision():
            seg = self.reference_segformer(weights)
            lg = reference_logits(seg, even_frames(self.pool["videos"][0]))
        P = self.person
        gap = torch.cat([lg[..., :P], lg[..., P + 1:]], -1).amax(-1) - lg[..., P]
        del seg, lg
        return float(torch.quantile(gap.flatten()[:1 << 20], SEG_SHARE))

    def call(self) -> Dict:
        """One step on the next pool batch, with its mix's draws."""
        i = self.calls % self.traffic["pool"]
        self.calls += 1
        self.metrics = self.step(self.state, {"videos": self.pool["videos"][i], "labels": self.pool["labels"][i]},
                                 generator=self.drop_gen,
                                 draws={k: self.pool[k][i] for k in ("perm", "keep", "frame")})
        return self.metrics

    def window(self, seconds: float) -> Dict:
        """`TrainEntry.window`, the mask model's operations on a clip's
        masked frames added to the model operations per clip."""
        rec = super().window(seconds)
        m, mm = self.cfg["model"], self.cfg["mask_model"]
        rec["flops_per_clip"] += spec.model(mm["name"]).flops_per_clip(mm, m["num_frames"] // 2, m["img_size"])
        return rec

    def profile(self, n: int) -> Dict:
        """`TrainEntry.profile`, and the mask model's device ms in the last
        profiled step (the program's device span `train.mask_model`; None
        where the program has none or ran off the card)."""
        from devias_tpu_torch.utils import profiling

        prof = super().profile(n)
        read = getattr(profiling, "device_span_ms", None)
        prof["mask_model_ms"] = read("train.mask_model") if read is not None else None
        return prof

    def mask_readings(self) -> Dict:
        """The program's mask module on the checked batches' even frames:
        its logits in float32 and its masks, as `segformer_frame_masks`
        gives them to the step."""
        from devias_tpu_torch.aug import segformer_frame_masks

        out = {"logits": [], "masks": []}
        for s in range(CHECKED_STEPS):
            kept = []

            def apply(frames):
                kept.append(self.seg(frames))
                return kept[-1]

            with torch.no_grad():
                masks = segformer_frame_masks(apply, self.pool["videos"][s])
            out["logits"].append(kept[0].float())
            out["masks"].append(masks.bool())
        return out

    def release(self) -> None:
        self.mask = self.mask_readings()
        del self.seg
        super().release()

    def reference_readings(self, quant: Optional[str] = None, half: bool = False,
                           fault: Optional[str] = None) -> Dict:
        """The reference over the checked steps, from the same weights,
        clips, labels and draws, with its own mask model's masks (the
        program's at near-ties), and under "mask" that model's logits,
        margins and masks. `quant` puts float8 products in the SegFormer,
        the student and the teacher; a `fault` (FAULTS) takes the masks of
        the odd frames, or mixes with none."""
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        mm = self.cfg["mask_model"]
        weights = mask_weights(mm, self.seed, self.device)
        weights["decode_head.classifier.bias"][self.person] += self.person_raise
        seg = self.reference_segformer(weights, quant)
        del weights
        logits = [reference_logits(seg, even_frames(self.pool["videos"][s], fault == "odd_frames"))
                  for s in range(CHECKED_STEPS)]
        del seg
        sigma = float(torch.cat([lg.flatten() for lg in logits]).std())
        B, T, H, W, _ = self.pool["videos"][0].shape
        mask = {"logits": logits, "sigma": sigma, "margin": [], "masks": []}
        batches, keeps = [], []
        g = generator(self.seed, DROP_STREAM, self.device)
        for s in range(CHECKED_STEPS):
            margin = ref_segformer.person_margin(logits[s], (H, W), self.person).reshape(B, T // 2, H, W)
            mask["margin"].append(margin)
            mask["masks"].append(margin > 0)
            masks = torch.where(margin.abs() < TIE_SIGMAS * sigma, self.mask["masks"][s], margin > 0).float()
            if fault == "no_mask":
                masks = torch.zeros_like(masks)
            batches.append({**{k: v[s] for k, v in self.pool.items()}, "masks": masks})
            keeps.append({i: tuple((torch.rand((self.B, 1, 1), generator=g, device=self.device) < 1.0 - r).view(-1)
                                   for _ in range(2))
                          for i, r in ref_model.drop_keep_shapes(self.cfg["model"])})
        out = ref_seg_train.run_train(self.cfg, make_weights(self.shapes, self.seed, self.device), batches, keeps,
                                      self.device, REF_ROWS, quant, half)
        out["mask"] = mask
        return out

    def check(self, limits: dict) -> Dict:
        with reference_precision():
            ref = self.reference_readings()
        return judge({**train_gaps(self.readings, ref), **mask_gaps(self.mask, ref["mask"])}, limits)


def make(cfg, traffic, seed, device):
    return SegformerTrainEntry(cfg, traffic, seed, device)
