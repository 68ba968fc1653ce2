"""The port's native resampler (``pevit_tpu_torch/native``) against the
reference's native path (``pevit_tpu/native``) and against PIL:

* byte-equal to the reference's library on up-sampling, down-sampling,
  identity and odd aspects, one image at a time and in a batch, and through
  ``data.transforms.resize_center_crop`` of both packages;
* within the reference's own PIL tolerance (PIL's fixed-point coefficients
  against the float filter: mean < 0.5, 99th percentile <= 1, max <= 3
  levels); ``use_native=False`` and ``resize_exact`` are PIL exactly;
* the library is built into ``pevit_tpu_torch/native/build/``, which git
  ignores, under a name keyed by the source; a source that fails to compile
  raises with g++'s message, and nothing falls back to PIL.
"""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import pevit_tpu.native as jnative
from pevit_tpu.data import transforms as jtransforms
from pevit_tpu_torch import native
from pevit_tpu_torch.data import transforms

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(100, 80, 3), (64, 64, 3), (300, 500, 3), (37, 220, 3), (16, 16, 3), (31, 17, 3),
          (224, 224, 3), (500, 301, 3)]
SIZES = [32, 224]


def _pil(arr: np.ndarray, size: int) -> np.ndarray:
    img = Image.fromarray(arr)
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(size, int(h * size / w))
    else:
        new_w, new_h = max(size, int(w * size / h)), size
    img = img.resize((new_w, new_h), Image.BICUBIC)
    left, top = int(round((new_w - size) / 2.0)), int(round((new_h - size) / 2.0))
    return np.asarray(img.crop((left, top, left + size, top + size)))


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_byte_equal_to_the_reference_native_path(shape, size):
    arr = _image(shape, seed=shape[0] * 7 + shape[1])
    want = jnative.native_resize_center_crop(arr, size)
    got = native.native_resize_center_crop(arr, size)
    assert got.shape == (size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(transforms.resize_center_crop(arr, size),
                                  jtransforms.resize_center_crop(arr, size))


@pytest.mark.parametrize("shape", [(4, 37, 220, 3), (3, 300, 200, 3)])
def test_batch_is_byte_equal_to_the_reference(shape):
    imgs = _image(shape, seed=3)
    want = jnative.native_resize_center_crop_batch(imgs, 64)
    got = native.native_resize_center_crop_batch(imgs, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], native.native_resize_center_crop(imgs[1], 64))


@pytest.mark.parametrize("shape", SHAPES)
def test_within_the_reference_tolerance_of_pil(shape):
    arr = _image(shape, seed=1)
    diff = np.abs(native.native_resize_center_crop(arr, 32).astype(int)
                  - _pil(arr, 32).astype(int))
    assert diff.mean() < 0.5 and np.percentile(diff, 99) <= 1 and diff.max() <= 3
    np.testing.assert_array_equal(transforms.resize_center_crop(arr, 32, use_native=False),
                                  _pil(arr, 32))
    np.testing.assert_array_equal(transforms.resize_exact(arr, 32),
                                  jtransforms.resize_exact(arr, 32))


def test_built_into_the_ignored_directory():
    path = native.build()
    assert path.parent == REPO / "pevit_tpu_torch" / "native" / "build"
    assert path == native.library_path() and path.exists()
    assert "pevit_tpu_torch/native/build/" in (REPO / ".gitignore").read_text().splitlines()
    assert native.SOURCE.read_bytes() == (REPO / "pevit_tpu/native/image_ops.cpp").read_bytes()
    assert '"pevit_tpu_torch.native": ["image_ops.cpp"]' in (REPO / "setup.py").read_text()


def test_a_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "image_ops.cpp"
    bad.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.NativeBuildError, match="error"):
        native.build(bad)
    assert not list((tmp_path / "build").glob("*.so"))
