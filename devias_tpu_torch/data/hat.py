"""HAT (Human-centric Action-swap Transfer) composite dataset (port of
`devias_tpu/data/hat.py`).

Builds action-swapped clips on the fly (ref dataset/hat_decode.py): the
segmented person of video A is pasted onto the inpainted background of
video B, shifted by the displacement between the centres of mass of the two
person masks on the first sampled frame.

Assets per sample (from the actionswap pickle annotation, ref
hat_decode.py:58-88):
  fg frames dir        (original/videos/<vid> or rawframes/<class>/<vid>)
  fg person masks dir  (seg/...)
  bg inpainted frames  (inpaint/... of another video)
  bg person masks      (seg/... of the bg video, its first frame only)
  background_len       (frames of the bg video)

labels.csv two directories above the annotation maps class names to ids
(ref hat_decode.py:49-56). PIL is imported where frames are read, so
importing this module needs no imaging library.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from devias_tpu_torch.data import transforms as T
from devias_tpu_torch.data.samplers import test_stride_indices, test_view_offsets, train_window_indices


def _center_of_mass(mask: np.ndarray) -> Tuple[float, float]:
    """scipy.ndimage.center_of_mass over a 2-D weight array (ref
    hat_decode.py:355-363)."""
    total = mask.sum()
    if total <= 0:
        return (mask.shape[0] / 2, mask.shape[1] / 2)
    ys = (mask.sum(axis=1) * np.arange(mask.shape[0])).sum() / total
    xs = (mask.sum(axis=0) * np.arange(mask.shape[1])).sum() / total
    return (ys, xs)


def _resize_short_to(img, short: int):
    from PIL import Image

    w, h = img.size
    if w > h:
        return img.resize((int(round(w * short / h)), short), Image.BILINEAR)
    return img.resize((short, int(round(h * short / w))), Image.BILINEAR)


class HATRecord:
    __slots__ = ("fg_frames", "fg_masks", "bg_inpaint", "bg_masks", "bg_len", "label", "vid")

    def __init__(self, fg_frames, fg_masks, bg_inpaint, bg_masks, bg_len, label, vid):
        self.fg_frames = fg_frames
        self.fg_masks = fg_masks
        self.bg_inpaint = bg_inpaint
        self.bg_masks = bg_masks
        self.bg_len = bg_len
        self.label = label
        self.vid = vid


def load_hat_annotation(anno_path: str, data_path: str, data_set: str) -> List[HATRecord]:
    """Parse an actionswap_{far,rand,close}_{1,2,3}.pickle annotation (ref
    hat_decode.py:58-88). labels.csv sits two directories up. The pickle is
    the dataset's own annotation file, read as the reference reads it."""
    anno_dir = os.path.dirname(os.path.dirname(anno_path))
    label_ind = {}
    with open(os.path.join(anno_dir, "labels.csv")) as f:
        for line in f:
            idx, name = line.strip().split(",", 1)
            label_ind[name] = int(idx)

    with open(anno_path, "rb") as f:
        cleaned = pickle.load(f)

    records = []
    for key_vid, contents in cleaned.items():
        fg_class, fg_vid = key_vid.split("/")[0], key_vid.split("/")[1]
        label = label_ind[fg_class]
        if data_set == "Kinetics-HAT":
            bg_vid = contents[0].split("/")[1]
            rec = HATRecord(
                fg_frames=os.path.join(data_path, "original/videos", fg_vid),
                fg_masks=os.path.join(data_path, "seg/videos", fg_vid),
                bg_inpaint=os.path.join(data_path, "inpaint/videos", bg_vid),
                bg_masks=os.path.join(data_path, "seg/videos", bg_vid),
                bg_len=int(contents[1]), label=label, vid=fg_vid,
            )
        else:  # UCF101-HAT
            rec = HATRecord(
                fg_frames=os.path.join(data_path, "rawframes", key_vid),
                fg_masks=os.path.join(data_path, "seg", key_vid),
                bg_inpaint=os.path.join(data_path, "inpaint", contents[0]),
                bg_masks=os.path.join(data_path, "seg", contents[0]),
                bg_len=int(contents[1]), label=label, vid=fg_vid,
            )
        records.append(rec)
    return records


def _fg_frame_name(data_set: str, idx: int, kind: str) -> str:
    """Frame-file naming (ref hat_decode.py:326-341, 368-378)."""
    if data_set == "UCF101-HAT":
        if kind == "frame":
            return f"image_{idx + 1:05d}.jpg"
        if kind == "bg":
            return f"img_{idx:05d}.jpg"
        return f"img_{idx:05d}.png"  # fg and bg masks
    # Kinetics-HAT: everything 1-based, 6 digits
    ext = "jpg" if kind in ("frame", "bg") else "png"
    return f"{idx + 1:06d}.{ext}"


def composite_clip(rec: HATRecord, indices: np.ndarray, data_set: str, video_len: int) -> np.ndarray:
    """Paste the fg person onto the inpainted bg for each sampled frame
    (ref hat_decode.py:302-380). Returns uint8 [T, H, W, C]."""
    from PIL import Image

    bg_indices = np.linspace(1, rec.bg_len, video_len, endpoint=False).astype(int)
    bg_for = bg_indices[indices]

    frames = []
    movement = None
    for i, (fi, bi) in enumerate(zip(indices.tolist(), bg_for.tolist())):
        img = Image.open(os.path.join(rec.fg_frames, _fg_frame_name(data_set, fi, "frame"))).convert("RGB")
        short = min(img.size)
        mask = Image.open(os.path.join(rec.fg_masks, _fg_frame_name(data_set, fi, "mask"))).convert("L")
        mask_np = np.asarray(mask.resize(img.size))

        if i == 0:
            bg_mask = Image.open(os.path.join(rec.bg_masks, _fg_frame_name(data_set, bi, "bgmask"))).convert("L")
            bg_mask = _resize_short_to(bg_mask, short)
            fg_c = _center_of_mass(mask_np.astype(np.float64))
            bg_c = _center_of_mass(np.asarray(bg_mask).astype(np.float64))
            movement = (int(bg_c[0] - fg_c[0]), int(bg_c[1] - fg_c[1]))

        binary = Image.fromarray(((mask_np > 128) * 255).astype(np.uint8)).convert("L")
        bg = Image.open(os.path.join(rec.bg_inpaint, _fg_frame_name(data_set, bi, "bg"))).convert("RGB")
        bg = _resize_short_to(bg, short)
        bg.paste(img, (movement[1], movement[0]), binary)
        frames.append(np.asarray(bg))
    return np.stack(frames)


class HATDataset:
    """Composite dataset over an actionswap annotation, with the record
    interface of `VideoDataset` (ref hat_decode.py train/val/test). Its
    train and validation windows draw from the process's global numpy and
    `random` states, as the JAX package's do."""

    def __init__(self, cfg, mode: str):
        self.cfg = cfg
        self.mode = mode
        self.records = load_hat_annotation(cfg.anno_path or cfg.data_path, cfg.data_prefix, cfg.data_set)
        if mode == "test":
            self.views = [(idx, ck, cp) for ck in range(cfg.test_num_segment) for cp in range(cfg.test_num_crop)
                          for idx in range(len(self.records))]

    def __len__(self):
        return len(self.views) if self.mode == "test" else len(self.records)

    def _video_len(self, rec: HATRecord) -> int:
        n = 0
        while os.path.isfile(os.path.join(rec.fg_frames, _fg_frame_name(self.cfg.data_set, n, "frame"))):
            n += 1
        return n

    def __getitem__(self, index: int):
        cfg = self.cfg
        if self.mode == "test":
            r_idx, ck, cp = self.views[index]
            rec = self.records[r_idx]
            vlen = self._video_len(rec)
            all_idx = test_stride_indices(vlen, cfg.num_frames, cfg.sampling_rate)
            if cfg.test_num_segment > 1:
                step = max((len(all_idx) - cfg.num_frames) / (cfg.test_num_segment - 1), 0)
                t0 = int(ck * step)
            else:
                t0 = (len(all_idx) - cfg.num_frames) // 2
            buffer = composite_clip(rec, all_idx[t0:t0 + cfg.num_frames], cfg.data_set, vlen)
            buffer = T.test_resize(buffer, cfg.short_side_size)
            _, s0, on_h = test_view_offsets(buffer.shape[0], buffer.shape[1:3], cfg.num_frames, cfg.short_side_size,
                                            0, cp, 1, cfg.test_num_crop)
            ss = cfg.short_side_size
            buffer = buffer[:, s0:s0 + ss, :, :] if on_h else buffer[:, :, s0:s0 + ss, :]
            return {
                "videos": np.ascontiguousarray(T.normalize_clip(buffer), np.float32),
                "labels": np.int64(rec.label),
                "video_id": rec.vid.rsplit(".", 1)[0],
                "chunk": np.int64(ck),
                "split": np.int64(cp),
            }

        rec = self.records[index]
        vlen = self._video_len(rec)
        if self.mode == "train":
            idx = train_window_indices(vlen, cfg.num_frames, cfg.sampling_rate)
            buffer = composite_clip(rec, idx, cfg.data_set, vlen)
            clip = T.train_augment(buffer, cfg.input_size, cfg.aa, reprob=cfg.reprob)
            return {"videos": clip, "labels": np.int64(rec.label)}
        idx = test_stride_indices(vlen, cfg.num_frames, cfg.sampling_rate)
        start = max((len(idx) - cfg.num_frames) // 2, 0)
        buffer = composite_clip(rec, idx[start:start + cfg.num_frames], cfg.data_set, vlen)
        return {
            "videos": T.val_transform(buffer, cfg.short_side_size, cfg.input_size),
            "labels": np.int64(rec.label),
            "video_id": rec.vid.rsplit(".", 1)[0],
        }
