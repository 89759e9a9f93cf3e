"""Frame-index samplers (pure functions over frame counts).

ref: dataset/kinetics.py:300-351 (decord window sampling / test stride),
dataset/ssv2.py:238-263 (TSN segments), dataset/kinetics.py:195-231
(deterministic test-view offsets), dataset/activitynet.py:71-83
(start/end windows).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def train_window_indices(
    num_frames: int,
    clip_len: int,
    frame_sample_rate: int,
    num_segment: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Random-window sampling (ref kinetics.py:330-346): per segment, pick a
    random end in [clip_len*rate, seg_len), take clip_len linspace indices
    over the preceding window; short videos pad with the segment end."""
    rng = rng or np.random.default_rng()
    converted_len = int(clip_len * frame_sample_rate)
    seg_len = num_frames // num_segment
    all_index: List[int] = []
    for i in range(num_segment):
        if seg_len <= converted_len:
            # mirror the reference formulas exactly, including the
            # degenerate seg_len < rate case (empty linspace -> all pad)
            # — ref kinetics.py:333-336
            n = seg_len // frame_sample_rate
            index = np.linspace(0, seg_len, num=n)
            index = np.concatenate((index, np.ones(clip_len - n) * seg_len))
            index = np.clip(index, 0, seg_len - 1).astype(np.int64)
        else:
            end_idx = int(rng.integers(converted_len, seg_len))
            str_idx = end_idx - converted_len
            index = np.linspace(str_idx, end_idx, num=clip_len)
            index = np.clip(index, str_idx, end_idx - 1).astype(np.int64)
        all_index.extend((index + i * seg_len).tolist())
    return np.asarray(all_index[:clip_len * num_segment], np.int64)


def test_stride_indices(num_frames: int, clip_len: int, frame_sample_rate: int) -> np.ndarray:
    """All frames at stride `rate`, right-padded to clip_len
    (ref kinetics.py:322-328). The caller slices temporal views from this."""
    idx = list(range(0, num_frames, frame_sample_rate))
    while len(idx) < clip_len:
        idx.append(idx[-1])
    return np.asarray(idx, np.int64)


def test_view_offsets(
    buffer_len: int,
    buffer_hw: Tuple[int, int],
    clip_len: int,
    short_side: int,
    chunk_nb: int,
    split_nb: int,
    test_num_segment: int,
    test_num_crop: int,
) -> Tuple[int, int, bool]:
    """Deterministic (temporal_start, spatial_start, crop_on_height) for
    view (chunk_nb, split_nb) on a short-side-resized buffer
    (ref kinetics.py:202-231)."""
    H, W = buffer_hw
    long_side = max(H, W)
    if test_num_crop > 1:
        spatial_step = 1.0 * (long_side - short_side) / (test_num_crop - 1)
        spatial_start = int(split_nb * spatial_step)
    else:
        spatial_start = (long_side - short_side) // 2
    if test_num_segment > 1:
        temporal_step = max(1.0 * (buffer_len - clip_len) / (test_num_segment - 1), 0)
        temporal_start = int(chunk_nb * temporal_step)
    else:
        temporal_start = (buffer_len - clip_len) // 2
    crop_on_height = H >= W
    return temporal_start, spatial_start, crop_on_height


def tsn_train_indices(
    num_frames: int, num_segment: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """SSv2 TSN sampling: one random frame per equal segment; short videos
    fall back to sorted-random or zeros (ref ssv2.py:251-259)."""
    rng = rng or np.random.default_rng()
    average_duration = num_frames // num_segment
    if average_duration > 0:
        base = np.arange(num_segment) * average_duration
        return (base + rng.integers(average_duration, size=num_segment)).astype(np.int64)
    if num_frames > num_segment:
        return np.sort(rng.integers(num_frames, size=num_segment)).astype(np.int64)
    return np.zeros(num_segment, np.int64)


def tsn_test_indices(num_frames: int, num_segment: int, test_num_segment: int = 2) -> np.ndarray:
    """SSv2 test: {tick/2 + tick*x} ∪ {tick*x}, right-padded to
    num_segment*test_num_segment, sorted (ref ssv2.py:238-248)."""
    tick = num_frames / float(num_segment)
    idx = [int(tick / 2.0 + tick * x) for x in range(num_segment)] + [
        int(tick * x) for x in range(num_segment)
    ]
    while len(idx) < num_segment * test_num_segment:
        idx.append(idx[-1])
    return np.sort(np.asarray(idx, np.int64))


def activitynet_indices(
    num_frames: int,
    start: float,
    end: float,
    duration: float,
    num_segment: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """ActivityNet segment sampling, exactly the reference's loader math
    (ref activitynet.py:83-88 ratio rounding + :243-262 index build, used
    for EVERY mode — the reference has one loader and it draws randomly in
    validation too): ratios rounded to 5 places, frame range over
    len(vr)-1, degenerate window clamped to length 1, TSN over the window,
    and the degenerate-branch quirk `arange(start, start+ns) % length`
    (which ignores the start offset)."""
    rng = rng or np.random.default_rng()
    if duration <= 0:  # defensive; the reference would divide by zero
        duration = 1.0
    start_ratio = round(float(start) / float(duration), 5)
    end_ratio = round(float(end) / float(duration), 5)
    if end_ratio > 1:
        end_ratio = 1.0
    total = num_frames - 1
    s = int(start_ratio * total)
    e = int(end_ratio * total)
    length = e - s
    if length <= 0:
        length = 1
    avg = length // num_segment
    if avg > 0:
        idx = s + np.arange(num_segment) * avg + np.asarray(
            rng.integers(avg, size=num_segment)
        )
    elif length > num_segment:
        # mirrored from the reference but mathematically unreachable:
        # avg == 0 implies length < num_segment (ref activitynet.py:258,
        # same dead branch there)
        idx = s + np.sort(np.asarray(rng.integers(length, size=num_segment)))
    else:
        idx = np.arange(s, s + num_segment) % length
    return idx.astype(np.int64)
