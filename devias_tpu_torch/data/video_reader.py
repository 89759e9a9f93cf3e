"""Video decoding backends (port of `devias_tpu/data/video_reader.py`).

  * NativeVideoReader — the port's C++ FFmpeg decode core
    (`data/native_decode.py`), random access through a frame index
  * OpenCVVideoReader — cv2.VideoCapture, a forward scan per batch
  * FrameFolderReader — JPEG frame directories read with PIL (SCUBA / *-BG
    / HAT assets, ref kinetics.py:352-385)
  * SyntheticReader — deterministic random frames for tests and the card's
    smoke run

All return uint8 [T, H, W, C] for a requested index array. cv2 and PIL are
imported by the readers that use them, so importing this module needs
neither. `open_video` prefers the decode core where it is on
(`native_decode.available()`: `pkg-config` resolves FFmpeg, decided once
per process), as the JAX package prefers its library, and takes cv2
elsewhere, or for a file the core cannot open. A failed build of the core
raises.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from devias_tpu_torch.data import native_decode


class VideoReadError(RuntimeError):
    pass


def reader_name() -> str:
    """The reader `open_video` takes for a video file."""
    return "native_decode" if native_decode.available() else "cv2"


def open_video(path: str, min_bytes: int = 1024):
    """Factory: a frame folder or a video file. Files smaller than 1KB are
    rejected (ref kinetics.py:309-311)."""
    if os.path.isdir(path):
        return FrameFolderReader(path)
    if not os.path.exists(path):
        raise VideoReadError(f"missing video {path}")
    if os.path.getsize(path) < min_bytes:
        raise VideoReadError(f"tiny video {path} ({os.path.getsize(path)}B)")
    if native_decode.available():
        native_decode._load()  # a failed build raises here
        try:
            return NativeVideoReader(path)
        except (RuntimeError, VideoReadError):
            pass  # a file the core cannot open goes to cv2, as in the JAX package
    return OpenCVVideoReader(path)


class NativeVideoReader:
    """Random-access decode through the C++ FFmpeg core."""

    def __init__(self, path: str):
        self._handle = native_decode.open(path)
        self.num_frames = native_decode.num_frames(self._handle)
        if self.num_frames <= 0:
            native_decode.close(self._handle)
            self._handle = None
            raise VideoReadError(f"no frames in {path}")

    def __len__(self):
        return self.num_frames

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        return native_decode.get_batch(self._handle, np.asarray(indices, np.int64))

    def close(self):
        if self._handle is not None:
            native_decode.close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class OpenCVVideoReader:
    """Sequential-scan decode via cv2.VideoCapture: decodes each needed
    frame once in index order (seek-per-frame is pathological on many
    codecs; a single forward scan matches decord's typical access)."""

    def __init__(self, path: str):
        import cv2

        self.path = path
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise VideoReadError(f"cannot open {path}")
        self.num_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        if self.num_frames <= 0:
            raise VideoReadError(f"no frames in {path}")

    def __len__(self):
        return self.num_frames

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        import cv2

        wanted = np.asarray(indices, np.int64)
        need = set(int(i) for i in wanted)
        max_need = max(need)
        cap = cv2.VideoCapture(self.path)
        try:
            frames: dict = {}
            cur = 0
            while cur <= max_need:
                ok, frame = cap.read()
                if not ok:
                    break
                if cur in need:
                    frames[cur] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                cur += 1
            if not frames:
                raise VideoReadError(f"decode produced no frames for {self.path}")
            fallback = frames[max(frames)]
            return np.stack([frames.get(int(i), fallback) for i in wanted])
        finally:
            cap.release()

    def close(self):
        pass


class FrameFolderReader:
    """JPEG frame directory. Supports the reference's naming schemes
    (ref kinetics.py:352-385): '<n:06d>.jpg' (1-based), 'frame<n:06d>.jpg',
    'img_<n:05d>.jpg' — auto-detected."""

    _PATTERNS = ("{:06d}.jpg", "frame{:06d}.jpg", "img_{:05d}.jpg")

    def __init__(self, path: str, video_len: Optional[int] = None):
        self.path = path
        self.pattern = None
        self.one_based = True
        for pat in self._PATTERNS:
            for base, one in ((1, True), (0, False)):
                if os.path.isfile(os.path.join(path, pat.format(base))):
                    self.pattern = pat
                    self.one_based = one
                    break
            if self.pattern:
                break
        if self.pattern is None:
            raise VideoReadError(f"no recognized frames in {path}")
        if video_len is not None:
            self.num_frames = video_len
        else:
            n = 0
            while os.path.isfile(
                os.path.join(path, self.pattern.format(n + (1 if self.one_based else 0)))
            ):
                n += 1
            self.num_frames = n

    def __len__(self):
        return self.num_frames

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        from PIL import Image

        frames = []
        for i in indices:
            n = int(i) + (1 if self.one_based else 0)
            n = min(max(n, 1 if self.one_based else 0),
                    self.num_frames - (0 if self.one_based else 1))
            fp = os.path.join(self.path, self.pattern.format(n))
            frames.append(np.asarray(Image.open(fp).convert("RGB")))
        return np.stack(frames)

    def close(self):
        pass


class SyntheticReader:
    """Deterministic random video for tests and benchmarks."""

    def __init__(self, num_frames: int = 64, height: int = 240, width: int = 320, seed: int = 0):
        self.num_frames = num_frames
        self.height = height
        self.width = width
        self.seed = seed

    def __len__(self):
        return self.num_frames

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        out = np.empty((len(indices), self.height, self.width, 3), np.uint8)
        for j, i in enumerate(indices):
            rng = np.random.default_rng(self.seed * 100003 + int(i))
            out[j] = rng.integers(0, 256, size=(self.height, self.width, 3), dtype=np.uint8)
        return out

    def close(self):
        pass
