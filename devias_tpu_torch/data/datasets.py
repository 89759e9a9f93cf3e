"""Dataset layer (port of `devias_tpu/data/datasets.py`): one generic
VideoDataset and the reference's dataset factory.

ref: dataset/datasets.py:18-446 (build_dataset switch), dataset/kinetics.py
(VideoClsDataset), dataset/ssv2.py, dataset/activitynet.py, dataset/hvu.py.

Samples are dict records with channels-last clips, float32 (or uint8 with
`host_normalize=False`):
  train:      {'videos': [T,H,W,C], 'labels': int}   (+'scene_labels' HVU)
  validation: + 'video_id'
  test:       + 'chunk', 'split'  (the flattened deterministic view grid,
              ref kinetics.py:105-122)

Places365 is the still-image scene probe (`PlacesDataset`); Kinetics-HAT
and UCF101-HAT are the action-swap composites of `data/hat.py`.
"""

from __future__ import annotations

import dataclasses
import os
import random
import zlib
from typing import List, Tuple

import numpy as np

from devias_tpu_torch.data import transforms as T
from devias_tpu_torch.data.filelist import FilelistEntry, read_filelist
from devias_tpu_torch.data.samplers import (
    activitynet_indices,
    test_stride_indices,
    test_view_offsets,
    train_window_indices,
    tsn_test_indices,
    tsn_train_indices,
)
from devias_tpu_torch.data.video_reader import FrameFolderReader, SyntheticReader, VideoReadError, open_video


@dataclasses.dataclass
class DataConfig:
    data_set: str = "Kinetics-400"
    data_path: str = ""      # filelist dir or csv (dataset-dependent, as in ref)
    data_prefix: str = ""    # video root
    anno_path: str = ""      # explicit csv (overrides data_path join)
    num_frames: int = 16
    sampling_rate: int = 4
    input_size: int = 224
    short_side_size: int = 224
    test_num_segment: int = 2
    test_num_crop: int = 3
    aa: str = "rand-m7-n4-mstd0.5-inc1"
    train_interpolation: str = "bicubic"  # RandAugment resample (ref --train_interpolation)
    reprob: float = 0.0
    num_sample: int = 1      # repeated augmentation crops per clip
    nb_classes: int = 400
    synthetic: bool = False      # tests and smoke runs: random frames
    # False ships uint8 clips and leaves /255 + ImageNet normalization to
    # the card (models built with input_norm=True)
    host_normalize: bool = True
    # Deterministic per-(epoch, index) host augmentation + frame-sampling
    # rng: a run is bit-reproducible across processes and across a resume
    # while drawing fresh augmentations every epoch. None restores
    # OS-entropy draws.
    aug_seed: object = 0  # Optional[int]


class VideoDataset:
    """Generic video classification dataset (ref VideoClsDataset)."""

    def __init__(self, entries: List[FilelistEntry], mode: str, cfg: DataConfig,
                 hflip: bool = True, frame_dirs: bool = False, tsn: bool = False):
        self.entries = entries
        self.mode = mode
        self.cfg = cfg
        self.hflip = hflip
        self.frame_dirs = frame_dirs
        self.tsn = tsn
        self.epoch = 0  # advanced by DataLoader.set_epoch (cfg.aug_seed)
        if mode == "test":
            # flatten the (chunk, split) view grid (ref kinetics.py:105-122)
            self.views: List[Tuple[int, int, int]] = []
            for ck in range(cfg.test_num_segment):
                for cp in range(cfg.test_num_crop):
                    for idx in range(len(entries)):
                        self.views.append((idx, ck, cp))

    def __len__(self):
        return len(self.views) if self.mode == "test" else len(self.entries)

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def _sample_rngs(self, index: int):
        """(python rng for the augment chain, numpy rng for the frame
        samplers), deterministic per (aug_seed, epoch, index) — or fresh
        OS-entropy when cfg.aug_seed is None."""
        if self.cfg.aug_seed is None:
            return random.Random(), None
        s = (
            (int(self.cfg.aug_seed) * 1_000_003 + self.epoch) * 1_000_003
            + index * 2 + 1
        ) % (2**63)
        return random.Random(s), np.random.default_rng(s ^ 0x9E3779B9)

    # -- decoding -----------------------------------------------------------

    def _open(self, entry: FilelistEntry):
        if self.cfg.synthetic:
            # crc32, not hash(): str hashing is randomized per process, and
            # synthetic clips must be identical across processes
            return SyntheticReader(seed=zlib.crc32(entry.path.encode()) % (2**31))
        if self.frame_dirs or os.path.isdir(entry.path):
            return FrameFolderReader(entry.path, video_len=entry.video_len)
        path = entry.path
        if entry.start is not None and not os.path.exists(path):
            # ActivityNet filelists carry extension-less names; the
            # reference probes mp4/mkv/webm (ref activitynet.py:219-228)
            for ext in ("mp4", "mkv", "webm"):
                if os.path.exists(f"{path}.{ext}"):
                    path = f"{path}.{ext}"
                    break
        return open_video(path)

    def _load_clip(self, entry: FilelistEntry, train: bool, rng=None) -> np.ndarray:
        cfg = self.cfg
        reader = self._open(entry)
        try:
            n = len(reader)
            if entry.start is not None:  # ActivityNet segment
                # one loader for every mode, like the reference
                # (ref activitynet.py:89,135 — validation draws randomly too)
                idx = activitynet_indices(n, entry.start, entry.end, entry.duration, cfg.num_frames)
                return reader.get_batch(idx.tolist())
            if self.tsn:
                idx = (
                    tsn_train_indices(n, cfg.num_frames, rng=rng)
                    if train
                    else tsn_test_indices(n, cfg.num_frames, cfg.test_num_segment)
                )
            elif train:
                idx = train_window_indices(n, cfg.num_frames, cfg.sampling_rate, rng=rng)
            else:
                idx = test_stride_indices(n, cfg.num_frames, cfg.sampling_rate)
            return reader.get_batch(idx.tolist())
        finally:
            reader.close()

    # -- getitem ------------------------------------------------------------

    def _getitem_resampling(self, index: int, fn):
        """Corrupt-video resampling loop (ref kinetics.py:131-136)."""
        for _ in range(20):
            try:
                return fn(index)
            except (VideoReadError, OSError):
                index = np.random.randint(len(self.entries))
        raise VideoReadError(f"too many corrupt samples near {index}")

    def __getitem__(self, index: int):
        if self.mode == "train":
            return self._getitem_resampling(index, self._train_item)
        if self.mode == "validation":
            return self._getitem_resampling(index, self._val_item)
        return self._test_item(index)

    def _train_item(self, index: int):
        cfg = self.cfg
        entry = self.entries[index]
        rng, np_rng = self._sample_rngs(index)
        buffer = self._load_clip(entry, train=True, rng=np_rng)

        def one():
            return T.train_augment(
                buffer, cfg.input_size, cfg.aa,
                horizontal_flip=self.hflip, reprob=cfg.reprob, rng=rng,
                host_normalize=cfg.host_normalize,
                interpolation=cfg.train_interpolation,
            )

        if cfg.num_sample > 1:
            # repeated augmentation (ref kinetics.py:138-148 + collate
            # utils/utils.py:551-573)
            return {
                "videos": np.stack([one() for _ in range(cfg.num_sample)]),
                "labels": np.full(cfg.num_sample, entry.label, np.int64),
                "repeated": True,
                **(
                    {"scene_labels": np.full(cfg.num_sample, entry.scene_label, np.int64)}
                    if entry.scene_label is not None
                    else {}
                ),
            }
        out = {"videos": one(), "labels": np.int64(entry.label)}
        if entry.scene_label is not None:
            out["scene_labels"] = np.int64(entry.scene_label)
        return out

    def _val_item(self, index: int):
        cfg = self.cfg
        entry = self.entries[index]
        buffer = self._load_clip(entry, train=False)
        if not self.tsn:
            # center clip_len window of the strided buffer
            start = max((buffer.shape[0] - cfg.num_frames) // 2, 0)
            buffer = buffer[start : start + cfg.num_frames]
        clip = T.val_transform(buffer, cfg.short_side_size, cfg.input_size, host_normalize=cfg.host_normalize)
        clip = clip[: cfg.num_frames] if self.tsn else clip
        out = {
            "videos": clip,
            "labels": np.int64(entry.label),
            "video_id": _vid(entry.path),
        }
        if entry.scene_label is not None:
            out["scene_labels"] = np.int64(entry.scene_label)
        return out

    def _test_item(self, index: int):
        cfg = self.cfg
        e_idx, chunk_nb, split_nb = self.views[index]
        entry = self.entries[e_idx]
        buffer = self._getitem_resampling(e_idx, lambda i: self._load_clip(self.entries[i], train=False))
        buffer = T.resize_clip_short_side(buffer, cfg.short_side_size)
        if self.tsn:
            # SSv2: temporal view = every other frame starting at chunk_nb
            frames = buffer[chunk_nb :: cfg.test_num_segment][: cfg.num_frames]
            while frames.shape[0] < cfg.num_frames:
                frames = np.concatenate([frames, frames[-1:]], 0)
            _, s_start, on_h = test_view_offsets(
                frames.shape[0], buffer.shape[1:3], cfg.num_frames,
                cfg.short_side_size, 0, split_nb, 1, cfg.test_num_crop,
            )
            buffer = frames
        else:
            t_start, s_start, on_h = test_view_offsets(
                buffer.shape[0], buffer.shape[1:3], cfg.num_frames,
                cfg.short_side_size, chunk_nb, split_nb,
                cfg.test_num_segment, cfg.test_num_crop,
            )
            buffer = buffer[t_start : t_start + cfg.num_frames]
        ss = cfg.short_side_size
        if on_h:
            buffer = buffer[:, s_start : s_start + ss, :, :]
        else:
            buffer = buffer[:, :, s_start : s_start + ss, :]
        if cfg.host_normalize:
            clip = np.ascontiguousarray(T.normalize_clip(buffer), np.float32)
        else:
            clip = np.ascontiguousarray(buffer, np.uint8)
        out = {
            "videos": clip,
            "labels": np.int64(entry.label),
            "video_id": _vid(entry.path),
            "chunk": np.int64(chunk_nb),
            "split": np.int64(split_nb),
        }
        if entry.scene_label is not None:
            out["scene_labels"] = np.int64(entry.scene_label)
        return out


def _vid(path: str) -> str:
    return os.path.basename(path).rsplit(".", 1)[0]


class PlacesDataset:
    """Still image inflated to a clip for the k-NN scene probe (ref
    dataset/datasets.py:567-609)."""

    def __init__(self, entries: List[FilelistEntry], cfg: DataConfig):
        self.entries = entries
        self.cfg = cfg

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, index):
        e = self.entries[index]
        if self.cfg.synthetic:
            img = np.random.default_rng(index).integers(0, 256, size=(256, 256, 3), dtype=np.uint8)
        else:
            from PIL import Image

            img = np.asarray(Image.open(e.path).convert("RGB"))
        clip = np.repeat(img[None], self.cfg.num_frames, axis=0)
        # the reference hard-codes Resize(256) + CenterCrop(224) for the
        # scene probe, whatever the run's input geometry
        # (ref dataset/datasets.py:581-586)
        clip = T.val_transform(clip, 256, 224)
        return {"videos": clip, "labels": np.int64(e.label), "video_id": _vid(e.path)}


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

_SIMPLE_CLASSES = {
    "Kinetics-400": 400,
    "UCF101": 101,
    "HMDB51": 51,
    "Diving-48": 48,
    "SSV2": 87,  # mini-SSv2 subset (ref datasets.py:232)
    "ActivityNet": 200,
    "SCUBA": None,   # nb from args
    "UCF101-BG": None,
    "Kinetics-BG": None,
}

HVU_NUM_ACTION_CLASSES = 739
HVU_NUM_SCENE_CLASSES = 248


def _anno(cfg: DataConfig, mode: str) -> str:
    if cfg.anno_path:
        return cfg.anno_path
    name = {"train": "train.csv", "validation": "val.csv", "test": "test.csv"}[mode]
    return os.path.join(cfg.data_path, name)


def build_dataset(is_train: bool, test_mode: bool, cfg: DataConfig):
    """The reference factory (ref dataset/datasets.py:18-446). Returns
    (dataset, nb_classes) — or ([seen, unseen], (739, 248)) for 'HVU-EVAL'
    (ref datasets.py:381-406)."""
    mode = "train" if is_train else ("test" if test_mode else "validation")
    ds_name = cfg.data_set

    if ds_name == "HVU":
        entries = read_filelist(_anno(cfg, mode), cfg.data_prefix, fmt="hvu")
        return VideoDataset(entries, mode, cfg), (HVU_NUM_ACTION_CLASSES, HVU_NUM_SCENE_CLASSES)

    if ds_name == "HVU-EVAL":
        # anno_path carries 'SEEN UNSEEN' (ref eval_slot_finetuning_hvu.py:41)
        out = []
        for a in cfg.anno_path.split():
            entries = read_filelist(a, cfg.data_prefix, fmt="hvu")
            out.append(VideoDataset(entries, "validation", dataclasses.replace(cfg, anno_path=a)))
        return out, (HVU_NUM_ACTION_CLASSES, HVU_NUM_SCENE_CLASSES)

    if ds_name in ("Kinetics-HAT", "UCF101-HAT"):
        from devias_tpu_torch.data.hat import HATDataset

        return HATDataset(cfg, mode), cfg.nb_classes

    if ds_name == "SCUBA":
        entries = read_filelist(_anno(cfg, mode), cfg.data_prefix, fmt="with_length")
        return VideoDataset(entries, mode, cfg, frame_dirs=True), cfg.nb_classes

    if ds_name in ("UCF101-BG", "Kinetics-BG"):
        prefix = "inpaint" if ds_name == "UCF101-BG" else "inpaint/videos"
        entries = read_filelist(_anno(cfg, mode), cfg.data_prefix, fmt="with_length", path_prefix=prefix)
        return VideoDataset(entries, mode, cfg, frame_dirs=True), cfg.nb_classes

    if ds_name == "SSV2":
        entries = read_filelist(_anno(cfg, mode), cfg.data_prefix)
        return VideoDataset(entries, mode, cfg, hflip=False, tsn=True), _SIMPLE_CLASSES["SSV2"]

    if ds_name == "Places365":
        return PlacesDataset(read_filelist(_anno(cfg, mode), cfg.data_prefix), cfg), 365

    if ds_name == "ActivityNet":
        entries = read_filelist(_anno(cfg, mode), cfg.data_prefix, fmt="activitynet")
        return VideoDataset(entries, mode, cfg), _SIMPLE_CLASSES["ActivityNet"]

    if ds_name in _SIMPLE_CLASSES:
        entries = read_filelist(_anno(cfg, mode), cfg.data_prefix)
        nb = _SIMPLE_CLASSES[ds_name] or cfg.nb_classes
        return VideoDataset(entries, mode, cfg), nb

    raise ValueError(f"unknown dataset {ds_name}")


def knn_build_dataset(train_split: bool, cfg: DataConfig):
    """k-NN feature-bank datasets (ref dataset/datasets.py:450-563): BOTH
    splits use deterministic validation-mode transforms — the reference
    builds even the train feature bank with mode='validation' (ref
    datasets.py:474,504). Returns (dataset, nb_classes)."""
    mode = "train" if train_split else "validation"
    if cfg.data_set == "Places365":
        return PlacesDataset(read_filelist(_anno(cfg, mode), cfg.data_prefix), cfg), 365
    entries = read_filelist(_anno(cfg, mode), cfg.data_prefix)
    nb = _SIMPLE_CLASSES.get(cfg.data_set) or cfg.nb_classes
    return VideoDataset(entries, "validation", cfg), nb
