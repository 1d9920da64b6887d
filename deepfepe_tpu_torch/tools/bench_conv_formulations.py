"""Conv-formulation shootout for the full-res 64->64 conv3x3 forward in bf16.

The port of `tools/bench_conv_formulations.py`: the same function, y =
relu(conv3x3_same(x, W) * s + t) in NHWC at SuperPointNetGauss2's widest
layer (inc.conv1: B=8, 376x1240, 64->64), bf16 with float32 sums and one
rounding to bf16, through the nine kinds of that tool, each on its CUDA
kernel in `ops/conv_formulations.py`:

  taps9, ky3, im2col    X4 `conv_strip`: a block per (image, th-row strip)
                        that walks it tw columns at a time
  dma-ky3, dma-im2col   X1 `conv_strip_async`: persistent blocks over th x tw
                        = 128-pixel items, the halo by TMA into a ring of
                        mbarrier stages, the products on wgmma
  t4-ky3, t4-im2col     X3 `conv_tile2d`: one block per th x tw tile
  s2dc, s2d9            X2 `conv_s2d`: X1's kernel on th x tg = 128-group items
                        of the s2d view, the weights streamed by TMA (2x the
                        useful FLOPs: half the packed weights are 0)

Spec grammar as the JAX tool's: kind_th[_tw], tw defaulting to 256, and
for taps9 to the full width padded to 16, as the JAX tool's taps9 strip.
A tile whose shared-memory staging exceeds a block's 227 KB raises
ValueError, as an unknown kind does, and so does an X1 or X2 tile other
than th x tw = 128. The JAX defaults (taps9_4 at full width, s2dc_16_64,
s2d9_32_128) are not taken; DEFAULT_KINDS keeps their three families at
tiles that are: taps9_4_64, s2dc_8_16, s2d9_8_16. ALL_KINDS has one spec
a kind.

The first line is the yardstick, the port's `conv3x3_affine_relu_ref` on
bf16 (cuDNN's bf16 conv, then the affine and ReLU in float32; "cudnn" on
the card); then one JSON line a kind with `ms` (marginal cost t(2k) - t(k)
of k calls, synchronized), `tc_pct` (FLOP / time over the H100's 989
TFLOP/s bf16 peak; null off the card) and `max_err` against the yardstick.
A spec that fails prints its error line and the tool exits 1.

    python -m deepfepe_tpu_torch.tools.bench_conv_formulations [--kinds=...]
        [--device cpu] [--iters N]

Runs on the card unless `--device cpu` is given (the plain versions; only
sensible at a small size, as the tests patch B, H, W).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import torch

from ..ops import conv_formulations as cf
from ..ops.conv import conv3x3_affine_relu_ref
from ..utils.device import resolve_device

B, H, W, C = 8, 376, 1240, 64
FLOP = B * H * W * 9 * 2 * C * C
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores

DEFAULT_KINDS = ("taps9_4_64", "s2dc_8_16", "s2d9_8_16")
ALL_KINDS = ("taps9_4_64", "ky3_4_32", "im2col_4_32", "dma-ky3_4_32", "dma-im2col_4_32",
             "t4-ky3_8_16", "t4-im2col_8_16", "s2dc_8_16", "s2d9_8_16")
# Each kind's (family, wrapper) in ops/conv_formulations.py.
ROUTES = {"taps9": ("strip", cf.conv_strip), "ky3": ("strip", cf.conv_strip),
          "im2col": ("strip", cf.conv_strip),
          "dma-ky3": ("strip_async", cf.conv_strip_async),
          "dma-im2col": ("strip_async", cf.conv_strip_async),
          "t4-ky3": ("tile2d", cf.conv_tile2d), "t4-im2col": ("tile2d", cf.conv_tile2d),
          "s2dc": ("s2d", cf.conv_s2d), "s2d9": ("s2d", cf.conv_s2d)}


def build(spec: str):
    """fn(x, w, s, t) for a spec kind_th[_tw]; ValueError on an unknown kind,
    on a tile no kernel takes, and on an odd W for s2d."""
    parts = spec.split("_")
    kind = parts[0]
    if kind not in ROUTES:
        raise ValueError(f"unknown kind {spec!r}")
    th = int(parts[1])
    # As in the JAX tool, taps9 without a tw spans the full (16-padded) width.
    tw = int(parts[2]) if len(parts) > 2 else cf.pad_up(W, 16) if kind == "taps9" else 256
    family, fn = ROUTES[kind]
    base = kind.split("-")[-1]
    cf.check_tile(family, base, th, tw)
    if family == "s2d":
        if W % 2:
            raise ValueError(f"s2d takes an even W, got {W}")
        return functools.partial(fn, kind=base, th=th, tg=tw)
    return functools.partial(fn, kind=base, th=th, tw=tw)


def _sync(device: torch.device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def timeit(f, *a, iters: int = 10) -> float:
    """Seconds a call: t(2k) - t(k) over k = iters calls, each run ending in
    a synchronize (1 + 3 iters calls in all)."""
    sync = _sync(a[0].device)
    f(*a)
    sync()

    def run(k):
        t0 = time.perf_counter()
        for _ in range(k):
            f(*a)
        sync()
        return time.perf_counter() - t0

    t1, t2 = run(iters), run(2 * iters)
    return max(t2 - t1, 1e-9) / iters


def inputs(device: torch.device, seed: int = 0):
    """x [B, H, W, C] bf16, w [3, 3, C, C] float32 * 0.1, s = 1, t = 0, as
    the JAX tool's, from a seeded torch.Generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, H, W, C, generator=g, device=device).to(torch.bfloat16)
    w = torch.randn(3, 3, C, C, generator=g, device=device) * 0.1
    return (x, w, torch.ones(C, device=device), torch.zeros(C, device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kinds", default=",".join(DEFAULT_KINDS),
                    help="comma-separated specs kind_th[_tw], or 'all'")
    ap.add_argument("--device", default=None, help="cpu for the plain versions (default: card)")
    ap.add_argument("--iters", type=int, default=10, help="k of the t(2k) - t(k) timing")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    kinds = ALL_KINDS if args.kinds == "all" else [k for k in args.kinds.split(",") if k]
    on_card = device.type == "cuda"

    def tc_pct(dt):
        return FLOP / dt / PEAK_BF16_FLOPS * 100 if on_card else None

    x, w, s, t = inputs(device)
    with torch.no_grad():
        dt = timeit(conv3x3_affine_relu_ref, x, w, s, t, iters=args.iters)
        ref_y = conv3x3_affine_relu_ref(x, w, s, t).float()
    print(json.dumps({"kind": "cudnn" if on_card else "ref", "ms": dt * 1e3,
                      "tc_pct": tc_pct(dt), "max_abs_y": ref_y.abs().max().item(),
                      "device": torch.cuda.get_device_name(device) if on_card else "cpu",
                      "shape": [B, H, W, C]}), flush=True)
    failed = 0
    for spec in kinds:
        try:
            f = build(spec)
            with torch.no_grad():
                err = (f(x, w, s, t).float() - ref_y).abs().max().item()
                dt = timeit(f, x, w, s, t, iters=args.iters)
            print(json.dumps({"kind": spec, "ms": dt * 1e3, "tc_pct": tc_pct(dt),
                              "max_err": err}), flush=True)
        except Exception as e:  # noqa: BLE001 - printed, and the tool exits 1
            failed += 1
            print(json.dumps({"kind": spec, "error": repr(e)[:300]}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
