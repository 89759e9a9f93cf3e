"""The port's FFmpeg decode core (`devias_tpu_torch/data/native_decode.py`,
built from its own copy of `native/decode_core.cpp` with the flags
pkg-config gives) against the JAX package's library, as
`tests/test_native_decode.py` tests that one, and against the cv2 reader:
on an mp4v clip written with cv2 the frames are bitwise equal. Also: the
choice of reader, made at import from pkg-config and the switch-off."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from devias_tpu.data import native_decode as jnd
from devias_tpu_torch.data import native_decode as nd
from devias_tpu_torch.data.video_reader import NativeVideoReader, OpenCVVideoReader, open_video, reader_name


def _write(path, n, hw, fill=None):
    import cv2

    h, w = hw
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
    rng = np.random.default_rng(0)
    frames = []
    for i in range(n):
        if fill is None:
            f = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            f[:, : w // 2] = (i * 6) % 250  # a flat half, so a frame's mean is its index
        else:
            f = np.full((h, w, 3), fill(i), np.uint8)
        frames.append(f)
        writer.write(f)
    writer.release()
    return frames


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vid") / "clip.mp4")
    return path, _write(path, 40, (240, 320))


def test_pkg_config_decides_and_core_is_the_ports_own(video):
    assert nd.available() and reader_name() == "native_decode" and jnd.available()
    h = nd.open(video[0])
    nd.close(h)
    assert os.path.dirname(nd._LIB._name).endswith(os.path.join("devias_tpu_torch", "data", "_build"))


def test_open_count_close(video):
    h = nd.open(video[0])
    assert nd.num_frames(h) == 40
    assert nd.frame_size(h) == (240, 320)
    nd.close(h)


def test_get_batch_equals_jax_core_and_cv2(video):
    """Frames 0, 3, 7, 20, 39 (and a repeat) in request order: bitwise
    equal to the JAX package's core and to cv2's forward scan."""
    path, frames = video
    idx = np.asarray([7, 0, 39, 7, 20, 3], np.int64)
    h, jh = nd.open(path), jnd.open(path)
    got, want = nd.get_batch(h, idx), jnd.get_batch(jh, idx)
    nd.close(h)
    jnd.close(jh)
    assert got.shape == (6, 240, 320, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, OpenCVVideoReader(path).get_batch(idx))
    for j, i in enumerate(idx):  # the lossy codec keeps each frame's flat half
        assert abs(float(got[j, :, :100].mean()) - (int(i) * 6) % 250) < 14, i


def test_out_of_range_indices_clamped(video):
    h = nd.open(video[0])
    got = nd.get_batch(h, np.asarray([1000, -5], np.int64))
    jh = jnd.open(video[0])
    np.testing.assert_array_equal(got, jnd.get_batch(jh, np.asarray([1000, -5], np.int64)))
    nd.close(h)
    jnd.close(jh)


def test_open_missing_file():
    with pytest.raises(RuntimeError):
        nd.open("/nonexistent/file.mp4")


def test_open_video_prefers_core(video):
    r = open_video(video[0])
    assert isinstance(r, NativeVideoReader) and len(r) == 40
    np.testing.assert_array_equal(r.get_batch([5, 2]), OpenCVVideoReader(video[0]).get_batch([5, 2]))
    r.close()


def test_index_cache_roundtrip_and_stale_file(video, tmp_path):
    path = str(tmp_path / "clip.mp4")
    shutil.copy(video[0], path)
    nd._INDEX_CACHE.clear()
    idx = np.asarray([3, 17, 0, 39], np.int64)
    h1 = nd.open(path)  # the scanning open fills the cache
    ref = nd.get_batch(h1, idx)
    nd.close(h1)
    pts, kf = nd._INDEX_CACHE[nd._cache_key(path)]
    assert len(pts) == 40 and kf[0] == 1  # the first frame is a keyframe
    h2 = nd.open(path)  # the cached open
    np.testing.assert_array_equal(nd.get_batch(h2, idx), ref)
    nd.close(h2)
    _write(path, 10, (48, 64), fill=lambda i: (i * 6) % 250)  # a new (mtime, size): a fresh scan
    h3 = nd.open(path)
    assert nd.num_frames(h3) == 10 and nd.frame_size(h3) == (48, 64)
    nd.close(h3)


@pytest.mark.parametrize("env,want", [({"PATH": "/nonexistent"}, "cv2"), ({}, "native_decode")],
                         ids=["no_pkg_config", "pkg_config"])
def test_reader_choice_at_import(video, env, want):
    """Where pkg-config is not found the readers stay on cv2, else they take
    the decode core; the clip decodes either way."""
    code = ("import sys\n"
            "from devias_tpu_torch.data import video_reader as vr\n"
            "r = vr.open_video(sys.argv[1])\n"
            "print(vr.reader_name(), type(r).__name__, r.get_batch([0, 39]).shape)\n")
    out = subprocess.run([sys.executable, "-c", code, video[0]], capture_output=True, text=True, timeout=120,
                         env={**os.environ, **env})
    assert out.returncode == 0, out.stderr
    reader = {"cv2": "OpenCVVideoReader", "native_decode": "NativeVideoReader"}[want]
    assert out.stdout.split() == [want, reader, "(2,", "240,", "320,", "3)"]
