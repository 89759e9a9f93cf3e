"""The port's host RandAugment core (`devias_tpu_torch/data/native_augment.py`,
built from its own copy of `native/augment_core.cpp`) against the JAX
package's library, op by op, and against the port's own numpy/cv2 path
as `tests/test_native_augment.py` holds the JAX copy: the integer ops, the
warps and Sharpness exactly, Color within blend rounding (one level).
Also: the switch-off, and that the core is built from the port's source
into its own build directory."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

from devias_tpu.data import fast_augment as JFA
from devias_tpu.data import native_augment as JNA
from devias_tpu_torch.data import fast_augment as FA
from devias_tpu_torch.data import native_augment as NA


@pytest.fixture(scope="module")
def clip():
    return np.random.default_rng(0).integers(0, 256, size=(6, 96, 128, 3)).astype(np.uint8)


def _python_path(monkeypatch, fn, *args, **kw):
    """Run `fn` with the port's core switched off."""
    with monkeypatch.context() as m:
        m.setattr(NA, "_LIB", None)
        m.setattr(NA, "_SEARCHED", True)
        return fn(*args, **kw)


def test_core_is_the_ports_own_build():
    assert NA.available() and NA.has_sharpness() and JNA.has_sharpness()
    path = NA._LIB._name
    assert os.path.dirname(path).endswith(os.path.join("devias_tpu_torch", "data", "_build")), path
    assert "native" not in os.path.basename(path)


def test_primitives_equal_jax_core(clip):
    np.testing.assert_array_equal(NA.gray601(clip), JNA.gray601(clip))
    np.testing.assert_array_equal(NA.gray_mean_per_frame(clip), JNA.gray_mean_per_frame(clip))
    hist = NA.hist_per_frame(clip)
    np.testing.assert_array_equal(hist, JNA.hist_per_frame(clip))
    luts = np.random.default_rng(1).integers(0, 256, size=(clip.shape[0], 3, 256)).astype(np.uint8)
    np.testing.assert_array_equal(NA.lut_per_frame(clip, luts), JNA.lut_per_frame(clip, luts))
    flags = [1, 0, 1, 1, 0, 0]
    for f in (-0.3, 0.2):
        np.testing.assert_array_equal(NA.warp_x(clip, f, 7.5, 128, flags), JNA.warp_x(clip, f, 7.5, 128, flags))
        np.testing.assert_array_equal(NA.warp_y(clip, f, -5.0, 128, flags), JNA.warp_y(clip, f, -5.0, 128, flags))
    for f in (0.0, 0.4, 1.7):
        np.testing.assert_array_equal(NA.sharpness_blend(clip, f), JNA.sharpness_blend(clip, f))
        d = np.abs(NA.color_blend(clip, f).astype(int) - JNA.color_blend(clip, f).astype(int))
        assert d.max() <= 1, (f, d.max())


OPS = [("AutoContrast", None), ("Equalize", None), ("Contrast", 1.63), ("Contrast", 0.4), ("Sharpness", 1.7),
       ("Sharpness", 0.3), ("ShearX", 0.2), ("ShearY", -0.2), ("TranslateXRel", 0.15), ("TranslateYRel", -0.15)]


@pytest.mark.parametrize("name,arg", OPS)
@pytest.mark.parametrize("interp", ["bicubic", "bilinear", "random"])
def test_ops_equal_jax_with_cores(clip, name, arg, interp):
    """`apply_fast_op` of both packages, each with its core on: the same
    clip and the same draws of the per-frame interpolation."""
    r1, r2 = random.Random(5), random.Random(5)
    got = FA.apply_fast_op(clip, name, arg, interpolation=interp, rng=r1)
    want = JFA.apply_fast_op(clip, name, arg, interpolation=interp, rng=r2)
    np.testing.assert_array_equal(got, want, err_msg=name)
    assert r1.getstate() == r2.getstate()


def test_color_equal_jax_within_blend_rounding(clip):
    for f in (0.3, 0.7, 1.4):
        d = np.abs(FA.apply_fast_op(clip, "Color", f).astype(int) - JFA.apply_fast_op(clip, "Color", f).astype(int))
        assert d.max() <= 1, (f, d.max())


@pytest.mark.parametrize("name,arg", [("AutoContrast", None), ("Equalize", None), ("Contrast", 1.63),
                                      ("Contrast", 0.4)])
def test_integer_ops_equal_python_path(clip, monkeypatch, name, arg):
    np.testing.assert_array_equal(FA.apply_fast_op(clip, name, arg),
                                  _python_path(monkeypatch, FA.apply_fast_op, clip, name, arg))
    flat = np.full((2, 16, 16, 3), 7, np.uint8)  # the identity-LUT branches
    np.testing.assert_array_equal(FA.apply_fast_op(flat, name, arg),
                                  _python_path(monkeypatch, FA.apply_fast_op, flat, name, arg))


def test_color_within_blend_rounding_of_python_path(clip, monkeypatch):
    for f in (0.3, 0.7, 1.4):
        d = np.abs(FA.apply_fast_op(clip, "Color", f).astype(int)
                   - _python_path(monkeypatch, FA.apply_fast_op, clip, "Color", f).astype(int))
        assert d.max() <= 1, (f, d.max())


def test_sharpness_exact_vs_pil(clip):
    from PIL import Image, ImageEnhance

    for f in (0.0, 0.4, 1.0, 1.6):
        pil = np.stack([np.asarray(ImageEnhance.Sharpness(Image.fromarray(fr)).enhance(f)) for fr in clip])
        np.testing.assert_array_equal(NA.sharpness_blend(clip, f), pil, err_msg=str(f))


def test_random_interp_stream_parity(clip, monkeypatch):
    """The core consumes the cv2 path's draws: one choice per frame."""
    r1, r2 = random.Random(5), random.Random(5)
    FA.apply_fast_op(clip, "ShearX", 0.2, interpolation="random", rng=r1)
    _python_path(monkeypatch, FA.apply_fast_op, clip, "ShearX", 0.2, interpolation="random", rng=r2)
    assert r1.getstate() == r2.getstate()


def test_bad_input_raises_before_the_core(clip):
    with pytest.raises(ValueError, match="uint8 clips"):
        NA.gray601(clip.astype(np.float32))
    with pytest.raises(ValueError, match="luts"):
        NA.lut_per_frame(clip, np.zeros((1, 3, 256), np.uint8))
    with pytest.raises(ValueError, match="interpolation flags"):
        NA.warp_x(clip, 0.2, 0.0, 128, [1, 0])


def test_switch_off_by_environment():
    code = ("from devias_tpu_torch.data import native_augment as NA\n"
            "print(NA.available(), NA._LIB)\n")
    env = dict(os.environ, DEVIAS_NO_NATIVE_AUGMENT="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "None"]
