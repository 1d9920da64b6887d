"""Write the image fixtures of this folder: small JPEG and PNG files in
the forms the port's readers cover, each beside its grey decode by
cv2.imread(IMREAD_GRAYSCALE) as an 8-bit grey PNG (`<name>.grey.png`).
The card's machine has no cv2; `chip_smoke.py`'s jpeg phase and
tests/test_torch_image_io.py hold the port's decode of each file to its
committed truth.

    python tests/fixtures/image_io/make_fixtures.py

needs cv2, PIL and numpy; the output is deterministic.
"""

import sys
from pathlib import Path

import cv2

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))

import _image_forms as forms  # noqa: E402


def fixtures():
    f = forms.frame
    return {
        "kitti_grey_q95.jpg": forms.cv2_jpeg(f(376, 1240, seed=1, noise=0.0), 95),
        "grey_q50_7x13.jpg": forms.cv2_jpeg(f(7, 13, seed=2), 50),
        "colour_420_q75.jpg": forms.cv2_jpeg(f(120, 160, True, seed=3), 75, "420"),
        "colour_411_q100.jpg": forms.cv2_jpeg(f(61, 90, True, seed=4), 100, "411"),
        "colour_422_restart.jpg": forms.cv2_jpeg(f(75, 101, True, seed=5), 90, "422", restart=2),
        "grey_progressive.jpg": forms.cv2_jpeg(f(96, 128, seed=6), 95, progressive=True),
        "colour_progressive.jpg": forms.cv2_jpeg(f(80, 120, True, seed=7), 85, "420",
                                                 progressive=True),
        "grey_optimized.jpg": forms.cv2_jpeg(f(64, 96, seed=8), 90, optimize=True),
        "pil_progressive.jpg": forms.pil_jpeg(f(70, 110, True, seed=9), 85, progressive=True),
        "exif_rotated_6.jpg": forms.with_exif_orientation(
            forms.cv2_jpeg(f(40, 64, True, seed=10), 90, "420"), 6),
        "tables_16bit.jpg": forms.with_16bit_tables(forms.cv2_jpeg(f(48, 48, seed=11), 40)),
        "small_first_component_h2v2.jpg": forms.small_first_component(37, 61, (2, 2)),
        "rgb_8bit.png": forms.png(2, 8, 0, 40, 56, seed=12, grey_rgb=True),
        "palette_4bit_adam7.png": forms.png(3, 4, 1, 33, 47, seed=13),
        "grey_alpha_16bit.png": forms.png(4, 16, 0, 21, 30, seed=14),
        "rgba_gamma_adam7.png": forms.png(6, 8, 1, 29, 35, seed=15, extra=forms.gamma_chunk()),
        "grey_2bit.png": forms.png(0, 2, 0, 17, 23, seed=16),
    }


def main():
    for name, data in fixtures().items():
        path = HERE / name
        path.write_bytes(data)
        grey = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        assert grey is not None, name
        assert cv2.imwrite(str(HERE / (name.split(".")[0] + ".grey.png")), grey,
                           [cv2.IMWRITE_PNG_COMPRESSION, 9])
    print(f"{len(fixtures())} fixtures in {HERE}")


if __name__ == "__main__":
    main()
