"""The port's native JPEG codec (`native/jpeg.cpp`, `utils/jpeg.py`)
against OpenCV (cv2.imread / cv2.imwrite with its libjpeg-turbo).

- The decoder equals `cv2.imdecode(..., IMREAD_GRAYSCALE)` bit for bit
  (bar 0) on files written here by cv2 and PIL: grey and colour; quality
  50, 75, 95 and 100; sampling 4:4:4, 4:2:2, 4:2:0, 4:1:1 and 4:4:0;
  sizes 1x1, 7x13, 375x1241 and 376x1240; cv2's restart interval,
  progressive and optimized-Huffman forms; PIL progressive; every EXIF
  orientation; 16-bit quantization tables; a first component smaller
  than the largest (each upsampling: fancy h2v1, h1v2, h2v2, box, 4x);
  and many threads decoding at once.
- Arithmetic, lossless, 12-bit, CMYK and incompletely refined progressive
  files raise NotImplementedError naming the ROADMAP item; truncated ones
  raise ValueError.
- The encoder writes cv2.imwrite's bytes exactly (markers, quantization
  tables and scan), so the decoded pixels are equal too.
"""

from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest

import _image_forms as forms
from deepfepe_tpu_torch.utils import jpeg

SIZES = [(1, 1), (7, 13), (375, 1241), (376, 1240)]


def _cv2_grey(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)


def _assert_decodes_as_cv2(data):
    want = _cv2_grey(data)
    got = jpeg.read_jpeg_grey(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


FORMS = {
    "grey_q50": lambda h, w: forms.cv2_jpeg(forms.frame(h, w), 50),
    "grey_q75": lambda h, w: forms.cv2_jpeg(forms.frame(h, w), 75),
    "grey_q95": lambda h, w: forms.cv2_jpeg(forms.frame(h, w), 95),
    "grey_q100": lambda h, w: forms.cv2_jpeg(forms.frame(h, w), 100),
    "colour_444_q95": lambda h, w: forms.cv2_jpeg(forms.frame(h, w, True), 95, "444"),
    "colour_422_q75": lambda h, w: forms.cv2_jpeg(forms.frame(h, w, True), 75, "422"),
    "colour_420_q50": lambda h, w: forms.cv2_jpeg(forms.frame(h, w, True), 50, "420"),
    "colour_411_q100": lambda h, w: forms.cv2_jpeg(forms.frame(h, w, True), 100, "411"),
    "colour_440_q95": lambda h, w: forms.cv2_jpeg(forms.frame(h, w, True), 95, "440"),
    "grey_restart": lambda h, w: forms.cv2_jpeg(forms.frame(h, w), 95, restart=2),
    "colour_restart": lambda h, w: forms.cv2_jpeg(forms.frame(h, w, True), 75, "420", restart=3),
    "grey_progressive": lambda h, w: forms.cv2_jpeg(forms.frame(h, w), 95, progressive=True),
    "colour_progressive": lambda h, w: forms.cv2_jpeg(forms.frame(h, w, True), 75, "420",
                                                      progressive=True),
    "colour_progressive_restart": lambda h, w: forms.cv2_jpeg(
        forms.frame(h, w, True), 90, "422", restart=1, progressive=True),
    "grey_optimized": lambda h, w: forms.cv2_jpeg(forms.frame(h, w), 95, optimize=True),
    "colour_optimized": lambda h, w: forms.cv2_jpeg(forms.frame(h, w, True), 75, "411",
                                                    optimize=True),
    "pil_grey": lambda h, w: forms.pil_jpeg(forms.frame(h, w), 90),
    "pil_colour_420": lambda h, w: forms.pil_jpeg(forms.frame(h, w, True), 80),
    "pil_grey_progressive": lambda h, w: forms.pil_jpeg(forms.frame(h, w), 90, progressive=True),
    "pil_colour_progressive": lambda h, w: forms.pil_jpeg(forms.frame(h, w, True), 85,
                                                          progressive=True, subsampling=1),
    "grey_16bit_tables": lambda h, w: forms.with_16bit_tables(forms.cv2_jpeg(forms.frame(h, w),
                                                                             60)),
}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("form", list(FORMS))
def test_decoder_equals_cv2(form, size):
    try:
        data = FORMS[form](*size)
    except OSError:  # PIL's progressive writer refuses a 1x1 image
        pytest.skip(f"{form} cannot write {size}")
    _assert_decodes_as_cv2(data)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_is_applied_as_cv2(orientation):
    data = forms.with_exif_orientation(forms.cv2_jpeg(forms.frame(21, 34, True), 90, "420"),
                                       orientation, big_endian=orientation % 2 == 0)
    _assert_decodes_as_cv2(data)
    assert jpeg.read_jpeg_grey(data).shape == ((34, 21) if orientation >= 5 else (21, 34))


@pytest.mark.parametrize("factors,size", [((2, 2), (37, 61)), ((2, 1), (40, 45)),
                                          ((1, 2), (33, 40)), ((4, 1), (24, 70)),
                                          ((2, 2), (9, 3)), ((2, 1), (8, 4)), ((4, 2), (30, 50))])
def test_a_smaller_first_component_is_upsampled_as_cv2(factors, size):
    """libjpeg upsamples the grey plane when it is not the largest
    component: fancy h2v1 (wider than 2), h1v2, fancy h2v2 (wider than 2),
    boxes for the narrow and the other integral ratios."""
    _assert_decodes_as_cv2(forms.small_first_component(*size, factors))


@pytest.mark.parametrize("name", list(forms.refused_streams()))
def test_refused_streams_raise(name):
    data, exc = forms.refused_streams()[name]
    with pytest.raises(exc, match="Queue 1 item 9" if exc is NotImplementedError else "JPEG|trunc"):
        jpeg.read_jpeg_grey(data)


def test_decoding_in_threads_gives_the_same_frames():
    datas = [forms.cv2_jpeg(forms.frame(120, 160, k % 2 == 1, seed=k), 90, "420" if k % 2 else None,
                            progressive=k % 3 == 0) for k in range(12)]
    want = [jpeg.read_jpeg_grey(d) for d in datas]
    with ThreadPoolExecutor(6) as pool:
        for _ in range(3):
            for a, b in zip(pool.map(jpeg.read_jpeg_grey, datas), want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [1, 10, 50, 75, 95, 100])
def test_encoder_writes_cv2s_bytes(size, quality, tmp_path):
    img = forms.frame(*size, seed=5)
    want = forms.cv2_jpeg(img, quality)
    got = jpeg.encode_jpeg_grey(img, quality)
    segs, scan = forms.segments(want)
    dqt = [want[a:b] for m, a, b in segs if m == 0xDB]
    assert dqt and all(t in got for t in dqt)  # the quantization table
    assert got[forms.segments(got)[1]:] == want[scan:]  # the scan
    assert got == want
    np.testing.assert_array_equal(jpeg.read_jpeg_grey(got), _cv2_grey(want))
    if quality == 95:
        jpeg.write_jpeg(tmp_path / "a.jpg", img)
        cv2.imwrite(str(tmp_path / "b.jpg"), img)
        assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()


def test_encoder_refuses_what_is_not_a_grey_image():
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode_jpeg_grey(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="range"):
        jpeg.encode_jpeg_grey(np.zeros((0, 4), np.uint8))
