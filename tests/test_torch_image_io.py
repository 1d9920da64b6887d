"""The port's PNG reader and frame dispatch (`utils/image_io.py`) against
cv2.imread(IMREAD_GRAYSCALE), bit for bit (bar 0).

- Every PNG form: colour types 0, 2, 3, 4 and 6 at each of their bit
  depths (1, 2, 4, 8, 16), plain and Adam7-interlaced (built here with
  zlib, every row filter), with grey-valued RGB pixels among the others;
  colour files with a gAMA or sRGB chunk (libpng's gamma path); an eXIf
  orientation; files written by cv2 and by PIL.
- `read_grey` tells JPEG from PNG by signature, as cv2 does.
- The committed fixtures (tests/fixtures/image_io/) decode equal to their
  committed cv2 decodes, and those equal cv2's decode here.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest

import _image_forms as forms
from deepfepe_tpu_torch.utils import image_io

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "image_io"
PNG_FORMS = [(c, d, i) for c, ds in forms.DEPTHS.items() for d in ds for i in (0, 1)]


def _check(path):
    want = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    assert want is not None
    got = image_io.read_grey(path)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("color,depth,interlace", PNG_FORMS,
                         ids=lambda v: str(v))
def test_png_forms_equal_cv2(color, depth, interlace, tmp_path):
    for k, (h, w) in enumerate([(1, 1), (7, 13), (37, 50)]):
        p = tmp_path / f"f{k}.png"
        p.write_bytes(forms.png(color, depth, interlace, h, w, seed=k, grey_rgb=True))
        _check(p)


@pytest.mark.parametrize("color,depth", [(2, 8), (3, 4), (3, 8), (6, 8), (0, 8), (4, 16)])
@pytest.mark.parametrize("chunk", ["gAMA", "gAMA_linear", "sRGB"])
def test_png_gamma_chunks_equal_cv2(color, depth, chunk, tmp_path):
    extra = {"gAMA": forms.gamma_chunk(), "gAMA_linear": forms.gamma_chunk(100000),
             "sRGB": forms.srgb_chunk()}[chunk]
    p = tmp_path / "g.png"
    p.write_bytes(forms.png(color, depth, 1, 23, 31, seed=4, extra=extra, grey_rgb=True))
    _check(p)


def test_png_16bit_colour_with_gamma_raises(tmp_path):
    p = tmp_path / "g.png"
    p.write_bytes(forms.png(2, 16, 0, 5, 6, extra=forms.gamma_chunk()))
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        image_io.read_png(p)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_equals_cv2(orientation, tmp_path):
    p = tmp_path / "o.png"
    p.write_bytes(forms.png(2, 8, 0, 11, 17, extra=forms.exif_chunk(orientation)))
    _check(p)


@pytest.mark.parametrize("mode", ["1", "L", "P", "LA", "RGB", "RGBA", "I;16"])
def test_pil_pngs_equal_cv2(mode, tmp_path):
    p = tmp_path / "p.png"
    p.write_bytes(forms.pil_png(forms.frame(45, 66, True, seed=2), mode))
    _check(p)


@pytest.mark.parametrize("kind", ["grey", "bgr", "bgra", "grey16", "bgr16"])
def test_cv2_pngs_equal_cv2(kind, tmp_path):
    img = forms.frame(376, 1240, True, seed=3)
    img = {"grey": img[..., 0], "bgr": img, "bgra": np.dstack([img, img[..., :1]]),
           "grey16": img[..., 0].astype(np.uint16) * 251,
           "bgr16": img.astype(np.uint16) * 257 + 3}[kind]
    p = tmp_path / "c.png"
    assert cv2.imwrite(str(p), img)
    _check(p)


def test_read_grey_tells_formats_by_signature(tmp_path):
    img = forms.frame(20, 30, True)
    (tmp_path / "a.png").write_bytes(forms.cv2_jpeg(img, 90, "420"))  # a JPEG named .png
    _check(tmp_path / "a.png")
    assert cv2.imwrite(str(tmp_path / "b.png"), img)
    (tmp_path / "b.jpg").write_bytes((tmp_path / "b.png").read_bytes())  # a PNG named .jpg
    _check(tmp_path / "b.jpg")
    (tmp_path / "c.bmp").write_bytes(b"BM....")
    with pytest.raises(ValueError, match="neither"):
        image_io.read_grey(tmp_path / "c.bmp")


def _fixture_pairs():
    return sorted((p, p.with_name(p.name.split(".")[0] + ".grey.png"))
                  for p in FIXTURES.iterdir()
                  if p.suffix in (".jpg", ".png") and not p.name.endswith(".grey.png"))


def test_the_fixtures_are_whole_and_small():
    pairs = _fixture_pairs()
    assert len(pairs) >= 12 and all(t.exists() for _, t in pairs)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 300 * 1024


@pytest.mark.parametrize("src,truth", _fixture_pairs(), ids=lambda p: p.name)
def test_fixtures_decode_to_their_cv2_truth(src, truth):
    want = image_io.read_png(truth)
    np.testing.assert_array_equal(cv2.imread(str(truth), cv2.IMREAD_GRAYSCALE), want)
    np.testing.assert_array_equal(cv2.imread(str(src), cv2.IMREAD_GRAYSCALE), want)
    np.testing.assert_array_equal(image_io.read_grey(src), want)
