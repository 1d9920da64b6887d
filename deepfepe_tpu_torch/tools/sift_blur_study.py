"""Does the SIFT pyramid need OpenCV's order of sums in its blur?

`frontend.sift.gaussian_blur` sums as OpenCV's AVX2 separable filter does:
fused multiply-adds (emulated in float64) on the columns its vector loops
take, separate products and sums on the tail columns, the column pass
from the centre tap out. This study runs the whole frontend on OpenCV's
committed cases (tests/fixtures/sift: the KITTI frame and two 376x1240
synthetic frames, at n_features 2000 and 300) with that blur and with
`plain_blur`, a float32 separable blur that sums each pass from its first
tap in separate products and sums, and prints one JSON line a case and
blur:

- `frontend.sift.compare_keypoints` against OpenCV's keypoints and
  descriptors, and whether it meets PARITY_BARS (`ok`);
- `in_place`: the share of OpenCV's rows whose row of the same number in
  the port's list is its pair (within 0.01 px and 0.1 deg). The loaders
  pick rows by number (`crop_or_pad_choice` under a seed), so a row out of
  place trains on another match;
- on a CUDA device, `pyramid_ms` and `frontend_ms`: host ms a frame
  around a synchronised call, the median of `--reps` warm calls.

    python -m deepfepe_tpu_torch.tools.sift_blur_study [--device cuda|cpu] [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..frontend import sift
from ..utils.device import no_tf32, resolve_device
from ..utils.image_io import read_grey

FIXTURES = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "fixtures", "sift")
FRAMES = ("kitti", "synthetic0", "synthetic1")
N_FEATURES = (2000, 300)


def plain_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """A float32 separable Gaussian blur with OpenCV's taps and
    BORDER_REFLECT_101, each pass summed from its first tap."""
    ksize = sift.blur_ksize(sigma)
    taps = [float(t) for t in sift.gaussian_taps(ksize, sigma)]
    r = ksize // 2
    H, W = img.shape
    s = img
    if W > 1:
        xp = img.index_select(1, torch.as_tensor(sift.reflect101(W, r), device=img.device))
        s = xp[:, :W] * taps[0]
        for k in range(1, ksize):
            s = s + xp[:, k:k + W] * taps[k]
    if H == 1:
        return s
    yp = s.index_select(0, torch.as_tensor(sift.reflect101(H, r), device=img.device))
    out = yp[:H] * taps[0]
    for k in range(1, ksize):
        out = out + yp[k:k + H] * taps[k]
    return out


BLURS = {"opencv_order": sift.gaussian_blur, "plain": plain_blur}


def in_place(kp: np.ndarray, want: np.ndarray, tol_px: float = 0.01,
             tol_deg: float = 0.1) -> float:
    n = min(len(kp), len(want))
    if len(want) == 0:
        return 1.0
    d = np.hypot(*(kp[:n, :2] - want[:n, :2]).T)
    da = np.abs(kp[:n, 3] - want[:n, 3])
    return float(((d <= tol_px) & (np.minimum(da, 360 - da) <= tol_deg)).sum() / len(want))


def host_ms(fn, reps: int, device) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t) * 1e3)
    return sorted(times)[reps // 2]


def study(device, reps: int = 5, frames=FRAMES, n_features=N_FEATURES):
    """Yields one dict a (frame, n_features, blur)."""
    for name in frames:
        img = read_grey(os.path.join(FIXTURES, f"{name}.png"))
        for n in n_features:
            z = np.load(os.path.join(FIXTURES, f"{name}_{n}.npz"))
            want_kp, want_des = z["kp"], z["des"].astype(np.float32)
            for blur_name, blur in BLURS.items():
                kp, des = sift.detect_and_compute(img, n, device, blur)
                kp, des = kp.cpu().numpy(), des.cpu().numpy()
                row = {"frame": name, "n_features": n, "blur": blur_name,
                       **sift.compare_keypoints(kp, des, want_kp, want_des),
                       "in_place": in_place(kp, want_kp)}
                if device.type == "cuda":
                    t = torch.as_tensor(img, device=device)

                    def pyramid():
                        with torch.no_grad(), no_tf32():
                            sift.build_pyramid(t, blur)

                    row["pyramid_ms"] = host_ms(pyramid, reps, device)
                    row["frontend_ms"] = host_ms(
                        lambda: sift.detect_and_compute(img, n, device, blur), reps, device)
                yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for row in study(device, args.reps):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
