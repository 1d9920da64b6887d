"""Port parity: the conv-formulation shootout (X1-X4) and its tool.

At a small size (B <= 2, H = 12, W = 40, C = 64; every kind at tiles of
th x tw = 128 pixels (X2: groups), X4's taps9 also at 256):

- Each of the nine kinds of `tools/bench_conv_formulations.py`, run through
  the JAX tool's own `build(spec)` in Pallas interpret mode (its module
  globals B, H, W, C patched; the tool is not changed), against the port's
  `build(spec)` on CPU tensors, which is the formulation's plain version,
  bit for bit. Bar: one bf16 ulp, |d| <= 2^-7 |y_jax| + 1e-6 (both sum
  exact bf16 products in float32, in other orders, and round once).
- The port's bf16 `conv3x3_affine_relu_ref` against the JAX package's
  within two ulps, |d| <= 2^-6 |y_jax| + 1e-6: both round the conv to
  bf16 and again after the affine.
- The weight packers against the JAX tool's, exactly.
- Each plain version against float64 from the same bf16 x and w: |d| <=
  2^-8 |y64| + 1e-5 (half an ulp of the one rounding, plus float32 sums of
  576 terms).
- `build`'s errors, and the tool's `main` on the CPU at the patched size.
- The wrappers refuse tensors off the CPU that are not CUDA (the `meta`
  device stands in for a card) and never fall back.
- `cuda`-marked cases, skipped without a card: each wrapper against its
  plain version at ragged and aligned shapes, within one ulp plus a float32
  floor, |d| <= 2^-7 |plain| + 1e-5 (where the affine cancels z s against
  t, the sums' rounding, ~1e-7 of the sum of |terms|, is left as an
  absolute error: one output of 710,400 read 3.8e-6 at y = 2.9e-4 on an
  H100), and against float64 at the bar above; exact launch counts, the
  kernels' shared-memory sizes against the module's, each wrapper's
  raises, a second call bit-identical for every family, and a refused
  launch and a refused tensor map reported.

Importing the JAX tool sets `jax_compilation_cache_dir`; the fixture that
imports it restores both cache settings. JAX is imported only there, so
the `cuda` cases run on a machine without JAX:

    python3 -m pytest tests/test_torch_conv_formulations.py -m cuda -q
"""

import importlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

cf = importlib.import_module("deepfepe_tpu_torch.ops.conv_formulations")
conv = importlib.import_module("deepfepe_tpu_torch.ops.conv")
tool = importlib.import_module("deepfepe_tpu_torch.tools.bench_conv_formulations")

REPO = Path(__file__).resolve().parents[1]
SMALL = {"B": 2, "H": 12, "W": 40, "C": 64}
SPECS = ["taps9_4_64", "ky3_4_32", "im2col_8_16", "dma-ky3_4_32", "dma-im2col_8_16",
         "t4-ky3_8_16", "t4-im2col_4_32", "s2dc_4_32", "s2d9_8_16"]
PLAIN_OF = {"taps9": "taps9", "ky3": "ky3", "im2col": "im2col", "dma-ky3": "ky3",
            "dma-im2col": "im2col", "t4-ky3": "ky3", "t4-im2col": "im2col", "s2dc": "s2dc",
            "s2d9": "s2d9"}
WRAPPERS = [(cf.conv_strip, "taps9", {"tw": 32}), (cf.conv_strip, "ky3", {"tw": 32}),
            (cf.conv_strip, "im2col", {"tw": 32}), (cf.conv_strip_async, "ky3", {"tw": 32}),
            (cf.conv_strip_async, "im2col", {"tw": 32}), (cf.conv_tile2d, "ky3", {"tw": 32}),
            (cf.conv_tile2d, "im2col", {"tw": 32}), (cf.conv_s2d, "s2dc", {"tg": 32}),
            (cf.conv_s2d, "s2d9", {"tg": 32})]
# What a tile no kernel takes raises: items are th x tw = 128 (X4: or 256),
# and the staging must fit a block's shared memory.
TILE_REFUSED = "shared memory|th x tw = 128"
WRAPPER_IDS = ["strip-taps9", "strip-ky3", "strip-im2col", "async-ky3", "async-im2col",
               "tile2d-ky3", "tile2d-im2col", "s2d-s2dc", "s2d-s2d9"]


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX tool, imported from its file; both cache settings it changes
    are restored afterwards."""
    import jax

    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                 "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "jax_bench_conv_formulations", REPO / "tools" / "bench_conv_formulations.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
        yield mod
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _numpy_inputs(B, H, W, seed=0):
    """x rounded to bf16 (as float32), w float32, non-trivial s and t."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, H, W, 64).astype(np.float32)).bfloat16().float().numpy()
    w = (rng.randn(3, 3, 64, 64) * 0.1).astype(np.float32)
    s = (rng.rand(64) + 0.5).astype(np.float32)
    t = (rng.randn(64) * 0.1).astype(np.float32)
    return x, w, s, t


def _torch(args, device="cpu"):
    x, w, s, t = (torch.from_numpy(a).to(device) for a in args)
    return x.bfloat16(), w, s, t


def _jax(args):
    import jax.numpy as jnp

    x, w, s, t = args
    return jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), jnp.asarray(s), jnp.asarray(t)


def _patch_sizes(monkeypatch, mod, B):
    for k, v in {**SMALL, "B": B}.items():
        monkeypatch.setattr(mod, k, v)


def _y64(x, w, s, t):
    """The function in float64 from x's and w's bf16 values."""
    z = F.conv2d(x.double().permute(0, 3, 1, 2),
                 w.bfloat16().double().permute(3, 2, 0, 1), padding=1)
    return torch.relu(z.permute(0, 2, 3, 1) * s.double() + t.double())


@pytest.mark.parametrize("spec", SPECS)
def test_each_kind_matches_the_jax_tool(jax_tool, monkeypatch, spec):
    B = 2 if spec.startswith(("taps9", "s2dc")) else 1
    _patch_sizes(monkeypatch, jax_tool, B)
    _patch_sizes(monkeypatch, tool, B)
    args = _numpy_inputs(B, 12, 40, seed=3)
    want = np.asarray(jax_tool.build(spec)(*_jax(args))).astype(np.float32)
    targs = _torch(args)
    got = tool.build(spec)(*targs)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 12, 40, 64)
    plain = cf.PLAIN[PLAIN_OF[spec.split("_")[0]]](*targs)
    assert torch.equal(got, plain)
    d = np.abs(got.float().numpy() - want)
    assert (d <= 2.0 ** -7 * np.abs(want) + 1e-6).all(), d.max()
    assert (want > 0).mean() > 0.3  # the ReLU leaves a real share of outputs


def test_bf16_reference_matches_jax_within_two_ulps():
    import jax.numpy as jnp

    from deepfepe_tpu.ops.pallas.conv_pallas import conv3x3_affine_relu_ref as jref

    args = _numpy_inputs(2, 12, 40, seed=4)
    want = np.asarray(jref(*_jax(args)).astype(jnp.float32))
    got = conv.conv3x3_affine_relu_ref(*_torch(args))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    d = np.abs(got.float().numpy() - want)
    assert (d <= 2.0 ** -6 * np.abs(want) + 1e-6).all(), d.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_float_references_are_unchanged(dtype):
    """float32 (float64) in, the same type out, the same bits as the formula
    in that type: only narrower types run the affine in float32."""
    x, w, s, t = (torch.from_numpy(a).to(dtype) for a in _numpy_inputs(1, 9, 14, seed=5))
    with conv.full_f32():
        z = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    want = torch.relu(z.permute(0, 2, 3, 1) * s + t)
    got = conv.conv3x3_affine_relu_ref(x, w, s, t)
    assert got.dtype == dtype and torch.equal(got, want)


def test_packers_match_the_jax_tool_exactly(jax_tool):
    import jax.numpy as jnp

    w = _numpy_inputs(1, 1, 2, seed=6)[1]
    wt, wj = torch.from_numpy(w), jnp.asarray(w)
    wbj = wj.astype(jnp.bfloat16)

    def same(a, b):
        return np.array_equal(a.float().numpy(), np.asarray(b).astype(np.float32))

    assert same(cf.pack_w_ky3(wt, torch.bfloat16), wbj.transpose(1, 0, 2, 3).reshape(3, 192, 64))
    assert same(cf.pack_w_im2col(wt, torch.bfloat16), wbj.reshape(576, 64))
    assert same(cf.pack_w_s2d(wt), jax_tool.pack_w_s2d(wj))
    assert same(cf.pack_w_s2d9(wt), jax_tool.pack_w_s2d9(wj))
    assert same(cf.pack_w("s2dc", wt, torch.bfloat16), jax_tool.pack_w_s2d(wj).astype(jnp.bfloat16))
    assert same(cf.pack_w("taps9", wt, torch.bfloat16), wbj)
    # Half of the s2d entries are structural zeros: 2x the useful FLOPs.
    assert (cf.pack_w_s2d(wt) == 0).float().mean().item() == 0.5


@pytest.mark.parametrize("kind", sorted(cf.PLAIN))
def test_plain_versions_against_float64(kind):
    x, w, s, t = _torch(_numpy_inputs(2, 13, 42, seed=7))
    y = cf.PLAIN[kind](x, w, s, t)
    y64 = _y64(x, w, s, t)
    assert y.dtype == torch.bfloat16 and y.shape == y64.shape
    d = (y.double() - y64).abs()
    assert bool((d <= 2.0 ** -8 * y64.abs() + 1e-5).all()), d.max().item()


def test_smem_follows_the_tile_sizes():
    """1024 bytes of alignment, the halo ring (a stage is one 1024-aligned
    [th+2, tw+2, 64] bf16 box a 64-channel half), the weights (72 KB
    resident for 64 channels, X2's 16 KB K slices), two 8 KB patch slots a
    warpgroup for im2col and s2dc (X3: one), 768 bytes of barriers, s and t. Items
    of th x tw = 128 (X4: or 256, four warpgroups); X3's block takes one
    item and one halo stage, X1 and X4 up to four and at least two."""
    for family in ("strip", "strip_async"):
        # At 4 x 32: a stage 6 * 34 * 128 = 26,112 -> 26,624 bytes; four of them.
        assert cf.smem_bytes(family, "ky3", 4, 32) == 1024 + 4 * 26_624 + 73_728 + 768
        assert cf.smem_bytes(family, "im2col", 4, 32) == \
            1024 + 4 * 26_624 + 73_728 + 32_768 + 768
        # At 1 x 128 a stage is 3 * 130 * 128 -> 50,176 bytes: im2col keeps two.
        assert cf.wgmma_layout(family, "im2col", 1, 128)["halo_stages"] == 2
    assert cf.smem_bytes("strip", "taps9", 4, 32) == cf.smem_bytes("strip", "ky3", 4, 32)
    # X4's 256-pixel chunks: four warpgroups; a stage 6 * 66 * 128 = 50,688
    # -> 51,200 bytes, three beside the weights (taps9_4_64 ships).
    lay = cf.wgmma_layout("strip", "taps9", 4, 64)
    assert (lay["nwg"], lay["halo_stages"]) == (4, 3)
    assert cf.smem_bytes("strip", "taps9", 4, 64) == 1024 + 3 * 51_200 + 73_728 + 768
    # im2col's eight patch slots leave room for one stage at 4 x 64: refused.
    assert cf.smem_bytes("strip", "im2col", 4, 64) == -1
    assert cf.wgmma_layout("strip", "im2col", 8, 32)["patch"] == 8 * cf.BOX
    # X3 at 8 x 16: one stage of 10 * 18 * 128 = 23,040 -> 23,552 bytes;
    # im2col's one patch slot a warpgroup adds 16 KB; either block leaves
    # room for a second on an SM's 228 KB (each with 1 KB the system keeps).
    assert cf.smem_bytes("tile2d", "ky3", 8, 16) == 1024 + 23_552 + 73_728 + 768 == 99_072
    assert cf.smem_bytes("tile2d", "im2col", 8, 16) == 99_072 + 16_384
    for kind in ("ky3", "im2col"):
        assert 2 * (cf.smem_bytes("tile2d", kind, 8, 16) + 1024) <= 233_472
    # X2 at 8 x 16: a stage 2 * (10 * 18 * 128 -> 23,552); two, and six
    # weight stages of 16 KB.
    lay = cf.wgmma_layout("s2d", "s2dc", 8, 16)
    assert (lay["halo_stages"], lay["w_stages"]) == (2, 6)
    assert cf.smem_bytes("s2d", "s2dc", 8, 16) == 1024 + 2 * 47_104 + 6 * 16_384 + 32_768 + 768
    assert cf.smem_bytes("s2d", "s2d9", 2, 64) == 1024 + 2 * 67_584 + 5 * 16_384 + 768
    assert cf.wgmma_layout("s2d", "s2dc", 2, 64)["w_stages"] == 3
    # Two halo stages of 1 x 128 groups leave room for one weight stage.
    assert cf.smem_bytes("s2d", "s2d9", 1, 128) == -1
    assert cf.smem_bytes("strip_async", "ky3", 4, 16) == -1 == cf.smem_bytes("s2d", "s2dc", 8, 32)
    assert cf.smem_bytes("strip", "ky3", 4, 24) == -1 == cf.smem_bytes("tile2d", "ky3", 4, 64)
    assert cf.smem_bytes("strip", "taps9", 1, 256) == -1  # two 99 KB stages do not fit
    assert cf.smem_bytes("tile2d", "taps9", 4, 32) == -1  # not a kind of X3
    for family, rows in cf.ITEM_ROWS.items():  # every tile they take fits
        for kind in cf.FAMILIES[family][1]:
            for n in rows:
                for th in (1, 2, 4, 8, 16, 32, 64, 128):
                    if n % th == 0:
                        assert cf.smem_bytes(family, kind, th, n // th) <= cf.SMEM_LIMIT
    for spec in (*tool.ALL_KINDS, *tool.DEFAULT_KINDS):
        tool.build(spec)  # every shipped tile fits


@pytest.mark.parametrize("spec,match", [
    ("nope_4", "unknown kind"), ("conv_4_16", "unknown kind"),
    ("taps9_4", "th x tw = 128 or 256"), ("s2dc_16_64", r"th x tw = 128 \("),
    ("s2d9_32_128", r"th x tw = 128 \("), ("im2col_8_64", "th x tw = 128 or 256"),
    ("ky3_4_24", "th x tw = 128 or 256"), ("dma-ky3_4_16", r"th x tw = 128 \("),
    ("s2d9_1_128", "shared memory"), ("im2col_4_64", "shared memory"),
    ("taps9_1_256", "shared memory"), ("t4-ky3_4_64", r"th x tw = 128 \("),
    ("t4-im2col_16_16", r"th x tw = 128 \(")])
def test_build_raises(spec, match):
    with pytest.raises(ValueError, match=match):
        tool.build(spec)


def test_build_refuses_an_odd_width_for_s2d(monkeypatch):
    monkeypatch.setattr(tool, "W", 41)
    with pytest.raises(ValueError, match="even"):
        tool.build("s2dc_4_32")
    tool.build("ky3_4_32")


def test_tool_main_on_the_cpu(monkeypatch, capsys):
    _patch_sizes(monkeypatch, tool, 1)
    assert tool.main(["--device", "cpu", "--kinds=" + ",".join(SPECS), "--iters", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["kind"] for ln in lines] == ["ref", *SPECS]
    ref = lines[0]
    assert ref["device"] == "cpu" and ref["tc_pct"] is None and ref["shape"] == [1, 12, 40, 64]
    for ln in lines[1:]:
        assert "error" not in ln and ln["ms"] > 0 and ln["tc_pct"] is None
        assert 0 <= ln["max_err"] <= 2.0 ** -6 * ref["max_abs_y"], ln


def test_tool_main_prints_a_failed_spec_and_exits_1(monkeypatch, capsys):
    _patch_sizes(monkeypatch, tool, 1)
    assert tool.main(["--device", "cpu", "--kinds=ky3_4_32,nope_4,s2dc_16_64",
                      "--iters", "1"]) == 1
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["kind"] for ln in lines] == ["ref", "ky3_4_32", "nope_4", "s2dc_16_64"]
    assert "error" not in lines[1]
    assert "unknown kind" in lines[2]["error"] and "th x tw = 128" in lines[3]["error"]


def test_tool_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--kinds=ky3_4_32"])


@pytest.mark.parametrize("fn,kind,tile", WRAPPERS, ids=WRAPPER_IDS)
def test_wrappers_on_the_cpu_are_the_plain_versions(fn, kind, tile):
    x, w, s, t = _torch(_numpy_inputs(1, 9, 34, seed=8))
    before = fn.launches
    assert torch.equal(fn(x, w, s, t, kind=kind, th=4, **tile), cf.PLAIN[kind](x, w, s, t))
    assert fn.launches == before
    with pytest.raises(ValueError, match=TILE_REFUSED):
        fn(x, w, s, t, kind=kind, th=64, **{k: 256 for k in tile})


@pytest.mark.parametrize("fn,kind,tile", WRAPPERS, ids=WRAPPER_IDS)
def test_off_cpu_the_wrappers_raise_and_never_fall_back(fn, kind, tile):
    x, w, s, t = (torch.empty(shape, device="meta")
                  for shape in ((1, 8, 32, 64), (3, 3, 64, 64), (64,), (64,)))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(x.bfloat16(), w, s, t, kind=kind, th=4, **tile)


def test_wrappers_refuse_a_kind_of_another_family():
    x, w, s, t = _torch(_numpy_inputs(1, 4, 16, seed=9))
    with pytest.raises(ValueError, match="takes kinds"):
        cf.conv_strip_async(x, w, s, t, kind="taps9", th=4, tw=16)
    with pytest.raises(ValueError, match="takes kinds"):
        cf.conv_s2d(x, w, s, t, kind="ky3", th=4, tg=16)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


CARD_SHAPES = [(2, 13, 42), (1, 16, 64), (1, 3, 18)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=["ragged", "aligned", "tiny"])
@pytest.mark.parametrize("fn,kind,tile", WRAPPERS, ids=WRAPPER_IDS)
def test_wrappers_match_plain_on_the_card(cuda, fn, kind, tile, shape):
    x, w, s, t = _torch(_numpy_inputs(*shape, seed=10), cuda)
    before = fn.launches
    with torch.no_grad():
        y = fn(x, w, s, t, kind=kind, th=4, **tile)
        plain = cf.PLAIN[kind](x, w, s, t)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    d = (y.float() - plain.float()).abs()
    assert bool((d <= 2.0 ** -7 * plain.float().abs() + 1e-5).all()), d.max().item()
    d64 = (y.double() - _y64(x, w, s, t)).abs()
    assert bool((d64 <= 2.0 ** -8 * _y64(x, w, s, t).abs() + 1e-5).all()), d64.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("spec", tool.ALL_KINDS)
def test_shipped_tiles_match_plain_on_the_card(cuda, monkeypatch, spec):
    _patch_sizes(monkeypatch, tool, 2)
    monkeypatch.setattr(tool, "H", 37)
    monkeypatch.setattr(tool, "W", 150)
    x, w, s, t = _torch(_numpy_inputs(2, 37, 150, seed=11), cuda)
    with torch.no_grad():
        y = tool.build(spec)(x, w, s, t)
        plain = cf.PLAIN[PLAIN_OF[spec.split("_")[0]]](x, w, s, t)
    torch.cuda.synchronize()
    d = (y.float() - plain.float()).abs()
    assert bool((d <= 2.0 ** -7 * plain.float().abs() + 1e-5).all()), d.max().item()


@pytest.mark.cuda
def test_kernel_smem_sizes_match_the_module(cuda):
    lib = cf._load()
    for family, (code, kinds) in cf.FAMILIES.items():
        for kind in kinds:
            for th, tw in ((1, 16), (4, 16), (4, 64), (8, 32), (16, 64), (1, 128), (2, 64),
                           (4, 32), (8, 16), (16, 8), (128, 1), (2, 128), (16, 16), (1, 256)):
                assert lib.conv_formulations_smem_bytes(code, cf.KINDS[kind], th, tw) == \
                    cf.smem_bytes(family, kind, th, tw)
    assert lib.conv_formulations_smem_bytes(0, 0, 4, 24) == -1
    assert lib.conv_formulations_smem_bytes(1, 0, 4, 16) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("fn,kind,tile", WRAPPERS, ids=WRAPPER_IDS)
def test_wrappers_raise_on_the_card(cuda, fn, kind, tile):
    x, w, s, t = _torch(_numpy_inputs(1, 8, 32, seed=12), cuda)
    kw = {"kind": kind, "th": 4, **tile}
    before = fn.launches
    with pytest.raises(ValueError, match="bf16"):
        fn(x.float(), w, s, t, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fn(x.transpose(1, 2).contiguous().transpose(1, 2), w, s, t, **kw)
    with pytest.raises(ValueError, match="bf16"):
        fn(x[..., :32].contiguous(), w, s, t, **kw)
    with pytest.raises(ValueError, match="float32"):
        fn(x, w, s.double(), t, **kw)
    with pytest.raises(ValueError, match="one device"):
        fn(x, w.cpu(), s, t, **kw)
    with pytest.raises(ValueError, match=TILE_REFUSED):
        fn(x, w, s, t, kind=kind, th=64, **{k: 256 for k in tile})
    if fn is cf.conv_s2d:
        with pytest.raises(ValueError, match="even"):
            fn(x[:, :, :31].contiguous(), w, s, t, **kw)
    assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("fn,kind,tile", WRAPPERS, ids=WRAPPER_IDS)
def test_a_second_call_is_bit_identical_on_the_card(cuda, fn, kind, tile):
    """No atomics and a fixed order of sums: every family repeats itself."""
    x, w, s, t = _torch(_numpy_inputs(2, 13, 42, seed=13), cuda)
    with torch.no_grad():
        y1 = fn(x, w, s, t, kind=kind, th=4, **tile)
        y2 = fn(x, w, s, t, kind=kind, th=4, **tile)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.cuda
def test_a_refused_launch_raises_on_the_card(cuda, monkeypatch):
    """X3's grid takes at most 65535 strips: the C interface refuses more
    with cudaErrorInvalidValue (1) before it touches memory, and the
    wrapper raises a refused launch as a RuntimeError and counts nothing."""
    lib = cf._load()
    x, w, s, t = _torch(_numpy_inputs(1, 8, 32, seed=14), cuda)
    wp = cf.pack_w("ky3", w, x.dtype).contiguous()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.conv_tile2d_bf16(x.data_ptr(), wp.data_ptr(), s.data_ptr(), t.data_ptr(),
                              y.data_ptr(), 1, 8 * 65536, 32, cf.KINDS["ky3"], 8, 16, stream)
    assert rc == 1

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1

    monkeypatch.setattr(cf, "_lib", Refusing())
    before = cf.conv_tile2d.launches
    with torch.no_grad(), pytest.raises(RuntimeError, match="launch failed: cudaError 1"):
        cf.conv_tile2d(x, w, s, t, kind="ky3", th=8, tw=16)
    assert cf.conv_tile2d.launches == before


@pytest.mark.cuda
def test_a_refused_tensor_map_is_reported_on_the_card(cuda, monkeypatch):
    """TMA takes a 16-byte aligned x: at an odd address the C interface
    returns ERR_TENSOR_MAP, which the wrapper raises as a RuntimeError."""
    lib = cf._load()
    x, w, s, t = _torch(_numpy_inputs(1, 8, 32, seed=15), cuda)
    wp = cf.pack_w("ky3", w, x.dtype).contiguous()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.conv_tile2d_bf16(x.data_ptr() + 2, wp.data_ptr(), s.data_ptr(), t.data_ptr(),
                              y.data_ptr(), 1, 8, 32, cf.KINDS["ky3"], 4, 32, stream)
    assert rc == cf.ERR_TENSOR_MAP

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: cf.ERR_TENSOR_MAP

    monkeypatch.setattr(cf, "_lib", Refusing())
    before = cf.conv_tile2d.launches
    with torch.no_grad(), pytest.raises(RuntimeError, match="tensor maps were refused"):
        cf.conv_tile2d(x, w, s, t, kind="ky3", th=4, tw=32)
    assert cf.conv_tile2d.launches == before
