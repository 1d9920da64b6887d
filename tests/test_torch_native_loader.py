"""The port's native .npy loader and its cv2-free image I/O.

- `load_npy` and `BatchPrefetcher` equal `np.load` bit for bit, dtype
  included, on every dtype and shape tests/test_native_loader.py covers
  (float32 [100, 5], float64 [7], int32 [3, 4, 5], int64 [6]), on 64 files
  through the pool, and on an empty [0, 6] match file; the library builds
  (g++) into build/torch_native/ under a content-hashed name.
- `read_png` reads cv2's PNGs (every row filter cv2 chooses) and cv2 reads
  `write_png`'s, both exactly; `resize_area` equals cv2's INTER_AREA within
  one grey level (exact at 376x1241 -> 376x1240, KITTI's resize, and at
  the other non-integer shrinks below); a `.jpg` frame raises.
"""

import numpy as np
import pytest

import cv2

from deepfepe_tpu_torch.data import native_loader
from deepfepe_tpu_torch.data.native_loader import BatchPrefetcher, load_npy, native_available
from deepfepe_tpu_torch.utils import image_io


@pytest.fixture
def npy_files(tmp_path):
    rng = np.random.RandomState(0)
    arrays = {
        "f32": rng.rand(100, 5).astype(np.float32),
        "f64": rng.rand(7).astype(np.float64),
        "i32": rng.randint(0, 100, (3, 4, 5)).astype(np.int32),
        "i64": rng.randint(0, 100, (6,)).astype(np.int64),
        "empty": np.zeros((0, 6), np.float32),
    }
    paths = {}
    for name, a in arrays.items():
        paths[name] = str(tmp_path / f"{name}.npy")
        np.save(paths[name], a)
    return paths, arrays


def test_native_build():
    assert native_available(), "g++ build of native/npy_loader.cpp failed"
    path = native_loader.library_path()
    assert path.exists() and path.parent.name == "torch_native"


def test_load_npy_equals_np_load(npy_files):
    paths, arrays = npy_files
    for name, a in arrays.items():
        got = load_npy(paths[name])
        np.testing.assert_array_equal(got, np.load(paths[name]))
        assert got.dtype == a.dtype and got.shape == a.shape, name
    with pytest.raises(IOError):
        load_npy(paths["f32"] + ".missing")


def test_batch_prefetcher(npy_files, tmp_path):
    paths, arrays = npy_files
    pf = BatchPrefetcher()
    names = list(arrays)
    for name, got in zip(names, pf.get(pf.submit([paths[n] for n in names]))):
        np.testing.assert_array_equal(got, arrays[name])
        assert got.dtype == arrays[name].dtype
    rng = np.random.RandomState(1)
    many = []
    for i in range(64):
        many.append((str(tmp_path / f"m{i}.npy"), rng.rand(50, 4).astype(np.float32)))
        np.save(*many[-1])
    for (_, a), b in zip(many, pf.get(pf.submit([p for p, _ in many]))):
        np.testing.assert_array_equal(a, b)


def _images():
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:120, 0:200]
    smooth = np.clip(127 + 120 * np.sin(xx / 7.0) * np.cos(yy / 5.0), 0, 255).astype(np.uint8)
    return {"noise": (rng.rand(120, 200) * 255).astype(np.uint8), "smooth": smooth}


def test_png_round_trips_with_cv2(tmp_path):
    p = str(tmp_path / "x.png")
    for name, img in _images().items():
        assert cv2.imwrite(p, img)
        np.testing.assert_array_equal(image_io.read_png(p), img, err_msg=name)
        image_io.write_png(p, img)
        np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_GRAYSCALE), img, err_msg=name)
    colour = np.stack([_images()["smooth"], _images()["noise"], _images()["smooth"][::-1]], -1)
    cv2.imwrite(p, colour)  # an RGB PNG reads as cv2 converts it to grey
    np.testing.assert_array_equal(image_io.read_png(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    (tmp_path / "f.jpg").write_bytes(b"\xff\xd8")  # a JPEG stream cut after its SOI
    with pytest.raises(ValueError, match="JPEG"):
        image_io.read_grey(tmp_path / "f.jpg")


@pytest.mark.parametrize("src,dst", [((376, 1241), (376, 1240)), ((120, 200), (37, 61)),
                                     ((120, 200), (60, 100)), ((120, 200), (150, 260)),
                                     ((120, 200), (90, 260)), ((120, 200), (120, 200))])
def test_resize_area_equals_cv2(src, dst):
    rng = np.random.RandomState(2)
    img = (rng.rand(*src) * 255).astype(np.uint8)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    got = image_io.resize_area(img, dst)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    if src[1] % dst[1] and src[0] >= dst[0] and src[1] > dst[1]:
        assert diff.max() == 0  # non-integer shrinks: OpenCV's table, exactly
