"""A CPU model of the tiling of `conv_wgmma_kernel` in
`deepfepe_tpu_torch/csrc/conv_formulations.cu` (X1-X4), in torch, at the
level of its addresses.

The model walks what the kernel does, with the kernel's own expressions:

- the blocks' items: X1 and X2 persistent (at most 132 blocks, block k
  taking items k, k + grid, ...); X4 a block per (image, strip) taking its
  chunks left to right; X3 a block per tile. An item is (image, strip of
  th rows, chunk of tw columns or groups) of th x tw = 64 nwg pixels, one
  64-row M tile for each of nwg warpgroups;
- the producer: one TMA box a 64-channel half, [1, th+2, tw+2, 64] at
  (b, r0 - 1, c0 - 1), zero outside the tensor, written under the 128-byte
  swizzle into its halo stage (item i of a block at stage i mod stages);
  the nine resident weight boxes of 64 channels; X2's weight slices of 64
  rows into a ring of stages, K slice s of item i at stage (18 i + s) mod
  w_stages;
- the consumers: A of every K slice (taps9 and im2col tap-major, ky3
  kx-major) for every warpgroup, by `ldmatrix` addresses on the halo
  (taps9, ky3, s2d9: lane l gives the row address of matrix l / 8), or
  built into a patch slot (s mod 2 of the warpgroup's two; X3's one) and
  read as a K-major swizzled tile (im2col, s2dc); B as the MN-major
  swizzled boxes; float32 products summed over the slices;
- the epilogue: the affine, the ReLU, one rounding to bf16, the quad
  transpose of the 16-byte chunks (emulated lane by lane with
  `__shfl_sync`'s semantics) and the row mask at the ragged edge.

Each kind runs at the card tests' ragged size (B = 2, H = 37, W = 150),
at tiny sizes and at every tile the tool ships, and must agree with its
plain version (`PLAIN`) within the card's bar, one bf16 ulp plus a float32
floor, |d| <= 2^-7 |plain| + 1e-5, with every output written exactly once.
Planted addressing faults must make it disagree. No JAX.
"""

import importlib

import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

cf = importlib.import_module("deepfepe_tpu_torch.ops.conv_formulations")
tool = importlib.import_module("deepfepe_tpu_torch.tools.bench_conv_formulations")

SMS = 132
KINDS = {"taps9": ("strip", "taps9"), "ky3": ("strip", "ky3"), "im2col": ("strip", "im2col"),
         "dma-ky3": ("strip_async", "ky3"), "dma-im2col": ("strip_async", "im2col"),
         "t4-ky3": ("tile2d", "ky3"), "t4-im2col": ("tile2d", "im2col"),
         "s2dc": ("s2d", "s2dc"), "s2d9": ("s2d", "s2d9")}
ULP, FLOOR = 2.0 ** -7, 1e-5


def swz(r, chunk):
    """Byte offset of 16-byte chunk `chunk` of 128-byte row r under the
    128-byte swizzle (the kernel's `swz`); r and chunk may be tensors."""
    return r * 128 + ((chunk ^ (r & 7)) << 4)


def slice_tap(kind: str, s: int):
    """(ky, kx, h) of K slice s: the kernel's `slice_tap`."""
    if kind in ("s2dc", "s2d9"):
        return (s >> 1) // 3, (s >> 1) % 3, s & 1
    if kind == "ky3":
        return s % 3, s // 3, 0
    return s // 3, s % 3, 0  # taps9, im2col


def walk(family, B, H, Wc, th, tw):
    """The blocks' items, {block: [(i, b, r0, c0), ...]}, the kernel's
    `block_walk` and `item_at`. Blocks are ints for X1, X2 and X4, (chunk,
    strip, image) for X3."""
    n_chunks = -(-Wc // tw)
    n_strips = -(-H // th)
    per_image = n_strips * n_chunks
    n_items = B * per_image

    def item_at(item):
        rem = item % per_image
        return item // per_image, rem // n_chunks * th, rem % n_chunks * tw

    out = {}
    if family == "strip":
        for block in range(B * n_strips):
            out[block] = [(i, *item_at(block * n_chunks + i)) for i in range(n_chunks)]
    elif family == "tile2d":
        for b in range(B):
            for strip in range(n_strips):
                for chunk in range(n_chunks):
                    out[chunk, strip, b] = [(0, *item_at((b * n_strips + strip) * n_chunks
                                                         + chunk))]
    else:
        grid = min(n_items, SMS)
        for block in range(grid):
            out[block] = [(i, *item_at(item))
                          for i, item in enumerate(range(block, n_items, grid))]
    return out


class Smem:
    """A block's shared memory as bf16 elements, addressed in bytes."""

    def __init__(self, nbytes: int):
        self.m = torch.zeros(nbytes // 2, dtype=torch.bfloat16)

    def read16(self, addr):
        """The 16 bytes at each byte address of `addr` (a tensor): [..., 8]."""
        return self.m[(addr // 2)[..., None] + torch.arange(8)]

    def write16(self, addr, v):
        self.m[(addr // 2)[..., None] + torch.arange(8)] = v


def tma_box(smem, dst, view, b, row0, col0, ch0, rows, cols):
    """The 4-D box [1, rows, cols, 64] of `view` [B, H, Wc, CIN] at (b, row0,
    col0, ch0), zero outside the tensor, written row by row (one element a
    128-byte row) under the swizzle at byte `dst`."""
    _, H, Wc, _ = view.shape
    box = torch.zeros(rows, cols, 64, dtype=view.dtype)
    r = torch.arange(rows) + row0
    c = torch.arange(cols) + col0
    ri, ci = (r >= 0) & (r < H), (c >= 0) & (c < Wc)
    sub = view[b][r[ri]][:, c[ci], ch0:ch0 + 64]
    box[ri.nonzero()[:, 0][:, None], ci.nonzero()[:, 0][None, :]] = sub
    n = rows * cols
    hr = torch.arange(n)[:, None]
    chunk = torch.arange(8)[None, :]
    smem.write16(dst + swz(hr, chunk), box.reshape(n, 8, 8))


def ldmatrix_a(smem, src, hr0, hc, ky, kx):
    """A [64, 64] of one warpgroup and K slice by ldmatrix x4: lane l of warp
    q addresses row (l & 7) + 8 ((l >> 3) & 1) of the warp's 16 at k chunk
    2 kk + (l >> 4) (the kernel's expressions); matrix m = l / 8 fills rows
    8 (m & 1).., k 8 (m >> 1).. of the warp's 16 x 16 step."""
    A = torch.zeros(64, 64, dtype=torch.bfloat16)
    lane = torch.arange(32)
    for q in range(4):
        hr = hr0[q] + ky * hc + kx  # [32]
        for kk in range(4):
            v = smem.read16(src + swz(hr, 2 * kk + (lane >> 4)))  # [32, 8]
            m = lane >> 3
            rows = 16 * q + (lane & 7) + 8 * (m & 1)
            cols = 16 * kk + 8 * (m >> 1)
            A[rows[:, None], cols[:, None] + torch.arange(8)] = v
    return A


def patch_a(smem, src, pslot, hr0p, hc, ky, kx):
    """A [64, 64] of one warpgroup and K slice through its patch slot: lane
    l of warp q copies chunks 4 (l & 1) .. + 3 of its row 16 q + l / 2,
    then wgmma reads the slot as a K-major 128-byte-swizzled tile."""
    lane = torch.arange(32)
    for q in range(4):
        arow = 16 * q + (lane >> 1)
        hr = hr0p[q] + ky * hc + kx
        for jj in range(4):
            j = (lane & 1) * 4 + jj
            smem.write16(pslot + swz(arow, j), smem.read16(src + swz(hr, j)))
    r = torch.arange(64)[:, None]
    c = torch.arange(8)[None, :]
    return smem.read16(pslot + swz(r, c)).reshape(64, 64)


def b_box(smem, base):
    """B [64 k, 64 n] of one MN-major swizzled box: row k, chunk c (n 8c..)."""
    k = torch.arange(64)[:, None]
    c = torch.arange(8)[None, :]
    return smem.read16(base + swz(k, c)).reshape(64, 64)


def quad_transpose(words):
    """The kernel's `quad_transpose` for one quad, words[t][c] the lane t's
    in[c]: rounds r = 0..3, lane t sends in[(t - r) & 3] and reads lane
    (t + r) & 3 into out[(t + r) & 3] (`__shfl_sync` within the quad)."""
    out = [[None] * 4 for _ in range(4)]
    for r in range(4):
        send = [words[t][(t - r) & 3] for t in range(4)]
        for t in range(4):
            out[t][(t + r) & 3] = send[(t + r) & 3]
    return out


def model(spec, x, w, s, t, fault=None):
    """y of the kernel for tool spec `spec`, by the model; also the count of
    writes of each output element and of writes past the end."""
    kind = spec.split("_")[0]
    th, tw = (int(v) for v in spec.split("_")[1:])
    family, base = KINDS[kind]
    cin = cf.CHANNELS[family]
    patch = base in cf.PATCH_KINDS
    lay = cf.wgmma_layout(family, base, th, tw)
    nwg = lay["nwg"]
    B, H, W, _ = x.shape
    view = x.reshape(B, H, W * 64 // cin, cin)
    Wc = view.shape[2]
    wp = cf.pack_w(base, w, torch.bfloat16).reshape(9 * cin, cin)
    NS, NJ = (9, 1) if cin == 64 else (18, 2)
    half = lay["halo_stage"] // NJ
    weights_off = lay["halo_stages"] * lay["halo_stage"]
    patch_off = weights_off + lay["weights"]
    smem = Smem(patch_off + lay["patch"])
    hc = tw + 2
    lane = torch.arange(32)

    # hr0 of each lane's A row: ldmatrix rows, or the patch rows it copies.
    def hr0_of(wg, arow):
        apx = 64 * wg + arow
        return apx // tw * hc + apx % tw

    hr0_ld = [[hr0_of(wg, 16 * q + (lane & 7) + ((lane >> 3) & 1) * 8) for q in range(4)]
              for wg in range(nwg)]
    hr0_pt = [[hr0_of(wg, 16 * q + (lane >> 1)) for q in range(4)] for wg in range(nwg)]
    if cin == 64:  # the resident weights: box s = packed rows 64 s..
        for sl in range(NS):
            tma_box_2d(smem, weights_off + sl * cf.BOX, wp, 64 * sl, 0)
    n_strips, n_chunks = -(-H // th), -(-Wc // tw)
    slots = cf.PATCH_SLOTS.get(family, 2)  # a warpgroup's patch slots
    ws_n = lay["w_stages"]
    y = torch.zeros(B * H * Wc * cin + 8 * cin, dtype=torch.bfloat16)  # room past the end
    count = torch.zeros(y.shape, dtype=torch.int32)
    sf = s.float()[torch.arange(cin) % 64]
    tf = t.float()[torch.arange(cin) % 64]
    for _, work in sorted(walk(family, B, H, Wc, th, tw).items()):
        for i, b, r0, c0 in work:
            hs = i % lay["halo_stages"]
            hb = hs * lay["halo_stage"]
            hbi, hr, hcl = b, r0, c0  # the item whose halo the producer brings
            if fault == "next_item" and family == "tile2d":  # the next tile's, wrapping
                item = ((b * n_strips + r0 // th) * n_chunks + c0 // tw + 1) % (B * n_strips
                                                                                  * n_chunks)
                rem = item % (n_strips * n_chunks)
                hbi, hr, hcl = item // (n_strips * n_chunks), rem // n_chunks * th, \
                    rem % n_chunks * tw
            top = hr if fault == "halo_top_row" else hr - 1
            left = hcl if fault == "halo_left_column" else hcl - 1
            for h in range(NJ):
                tma_box(smem, hb + h * half, view, hbi, top, left, 64 * h, th + 2, tw + 2)
            acc = [torch.zeros(64, cin) for _ in range(nwg)]
            for sl in range(NS):
                if cin == 128:  # the producer's slice into stage (18 i + s) mod w_stages
                    u = NS * i + sl
                    krow = 64 * (sl + 6 if fault == "next_ky" and sl < 6 else sl)
                    stage = weights_off + (u % ws_n) * 2 * cf.BOX
                    for j in range(2):
                        tma_box_2d(smem, stage + j * cf.BOX, wp, krow, 64 * j)
                    wb = weights_off + (u % ws_n) * 2 * cf.BOX
                else:
                    wb = weights_off + sl * cf.BOX
                ky, kx, h = slice_tap(base, sl)
                if fault == "tap_shift" and base == "taps9" and sl == 4:
                    kx += 1  # the centre tap one column to the right
                src = hb + h * half
                Bm = torch.cat([b_box(smem, wb + j * cf.BOX) for j in range(NJ)], dim=1)
                for wg in range(nwg):
                    if patch:
                        slot = slots * wg + sl % slots
                        A = patch_a(smem, src, patch_off + slot * cf.BOX, hr0_pt[wg], hc, ky, kx)
                    elif fault == "no_swizzle":
                        A = ldmatrix_a_plain(smem, src, hr0_ld[wg], hc, ky, kx)
                    else:
                        A = ldmatrix_a(smem, src, hr0_ld[wg], hc, ky, kx)
                    acc[wg] += A.float() @ Bm.float()
            for wg in range(nwg):
                z = torch.relu(acc[wg] * sf + tf).bfloat16()  # [64 rows, cin]
                for r in range(64):
                    px = 64 * wg + r
                    row, col = r0 + px // tw, c0 + px % tw
                    if fault != "no_row_mask" and not (row < H and col < Wc):
                        continue
                    off = ((b * H + row) * Wc + col) * cin
                    if off < 0 or off + cin > y.numel():
                        continue  # an unmasked row past the end of the buffer
                    y[off:off + cin] = z[r]
                    count[off:off + cin] += 1
    n = B * H * Wc * cin
    return y[:n].view(B, H, W, 64), count[:n].view(B, H, W, 64), count[n:]


def tma_box_2d(smem, dst, mat, row0, col0):
    """A 2-D [64 rows][64 cols] box of `mat` at (row0, col0) under the
    swizzle, zero past the tensor's end."""
    box = torch.zeros(64, 64, dtype=mat.dtype)
    part = mat[row0:row0 + 64, col0:col0 + 64]
    box[:part.shape[0], :part.shape[1]] = part
    k = torch.arange(64)[:, None]
    c = torch.arange(8)[None, :]
    smem.write16(dst + swz(k, c), box.reshape(64, 8, 8))


def ldmatrix_a_plain(smem, src, hr0, hc, ky, kx):
    """ldmatrix_a with the swizzle left out of the address (a fault)."""
    A = torch.zeros(64, 64, dtype=torch.bfloat16)
    lane = torch.arange(32)
    for q in range(4):
        hr = hr0[q] + ky * hc + kx
        for kk in range(4):
            v = smem.read16(src + hr * 128 + ((2 * kk + (lane >> 4)) << 4))
            m = lane >> 3
            A[(16 * q + (lane & 7) + 8 * (m & 1))[:, None],
              (16 * kk + 8 * (m >> 1))[:, None] + torch.arange(8)] = v
    return A


def inputs(B, H, W, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, H, W, 64, generator=g).bfloat16()
    w = torch.randn(3, 3, 64, 64, generator=g) * 0.1
    s = torch.rand(64, generator=g) + 0.5
    t = torch.randn(64, generator=g) * 0.1
    return x, w, s, t


def within(y, plain):
    d = (y.float() - plain.float()).abs()
    return bool((d <= ULP * plain.float().abs() + FLOOR).all()), d.max().item()


def _specs():
    return [k for k in tool.ALL_KINDS if k.split("_")[0] in KINDS]


@pytest.mark.parametrize("spec", _specs())
def test_model_of_the_shipped_tiles_matches_plain_at_the_ragged_size(spec):
    x, w, s, t = inputs(2, 37, 150, seed=1)
    y, count, past = model(spec, x, w, s, t)
    plain = cf.PLAIN[KINDS[spec.split("_")[0]][1]](x, w, s, t)
    ok, worst = within(y, plain)
    assert ok, worst
    assert bool((count == 1).all()) and int(past.sum()) == 0
    assert (plain > 0).float().mean() > 0.3


@pytest.mark.parametrize("shape", [(1, 3, 18), (1, 1, 2), (2, 9, 34)], ids=["3x18", "1x2", "9x34"])
@pytest.mark.parametrize("spec", ["dma-ky3_1_128", "dma-im2col_16_8", "s2dc_2_64",
                                  "s2d9_16_8", "taps9_2_128", "ky3_16_16", "im2col_1_128",
                                  "t4-ky3_16_8", "t4-im2col_2_64", "t4-ky3_1_128"])
def test_model_at_tiny_sizes_and_odd_tiles(spec, shape):
    x, w, s, t = inputs(*shape, seed=2)
    y, count, past = model(spec, x, w, s, t)
    plain = cf.PLAIN[KINDS[spec.split("_")[0]][1]](x, w, s, t)
    ok, worst = within(y, plain)
    assert ok, worst
    assert bool((count == 1).all()) and int(past.sum()) == 0


@pytest.mark.parametrize("fault,spec", [("halo_top_row", "dma-ky3_4_32"),
                                        ("halo_top_row", "s2d9_8_16"),
                                        ("next_ky", "s2dc_8_16"), ("next_ky", "s2d9_8_16"),
                                        ("no_swizzle", "dma-ky3_4_32"),
                                        ("no_row_mask", "dma-im2col_4_32"),
                                        ("halo_left_column", "taps9_4_64"),
                                        ("halo_left_column", "im2col_4_32"),
                                        ("next_item", "t4-ky3_8_16"),
                                        ("next_item", "t4-im2col_8_16"),
                                        ("tap_shift", "taps9_4_64")])
def test_model_catches_planted_addressing_faults(fault, spec):
    x, w, s, t = inputs(1, 13, 42, seed=3)
    y, count, past = model(spec, x, w, s, t, fault=fault)
    plain = cf.PLAIN[KINDS[spec.split("_")[0]][1]](x, w, s, t)
    ok, _ = within(y, plain)
    assert not (ok and bool((count == 1).all()) and int(past.sum()) == 0)


SIZES = ((8, 376, 1240, 4, 32), (8, 376, 620, 8, 16), (2, 37, 75, 8, 16), (1, 1, 1, 1, 128),
         (8, 376, 1240, 4, 64))


def _covers_every_item_once(work, B, H, Wc, th, tw):
    seen = sorted((b, r0, c0) for v in work.values() for _, b, r0, c0 in v)
    want = sorted((b, r, c) for b in range(B) for r in range(0, H, th) for c in range(0, Wc, tw))
    assert seen == want
    assert all([i for i, *_ in v] == list(range(len(v))) for v in work.values())


def test_walk_covers_every_item_once_and_balances_the_blocks():
    """X1 and X2: at most one block an SM, balanced, items in order."""
    for family in ("strip_async", "s2d"):
        for B, H, Wc, th, tw in SIZES:
            work = walk(family, B, H, Wc, th, tw)
            _covers_every_item_once(work, B, H, Wc, th, tw)
            sizes = [len(v) for v in work.values()]
            assert len(work) <= SMS and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("family", ["strip", "tile2d"])
def test_strip_and_tile_walks_cover_every_item_once(family):
    """X4: a block per (image, strip), its chunks left to right. X3: one
    item a block."""
    for B, H, Wc, th, tw in SIZES:
        work = walk(family, B, H, Wc, th, tw)
        _covers_every_item_once(work, B, H, Wc, th, tw)
        n_chunks, n_strips = -(-Wc // tw), -(-H // th)
        if family == "strip":
            assert len(work) == B * n_strips
            for v in work.values():
                assert len({(b, r0) for _, b, r0, _ in v}) == 1
                assert [c0 for *_, c0 in v] == list(range(0, Wc, tw))
        else:
            assert len(work) == n_chunks * n_strips * B
            assert all(len(v) == 1 for v in work.values())
    # inc.conv1 at X4's 4 x 64: 752 blocks of 20 chunks; X3's 8 x 16: (78, 47, 8).
    assert len(walk("strip", 8, 376, 1240, 4, 64)) == 752
    assert len(walk("tile2d", 8, 376, 1240, 8, 16)) == 78 * 47 * 8 == 29_328


def test_quad_transpose_gives_each_lane_its_chunk():
    words = [[(t, c) for c in range(4)] for t in range(4)]  # lane t's two columns of chunk c
    out = quad_transpose(words)
    for t in range(4):
        assert out[t] == [(j, t) for j in range(4)]  # chunk t, word j from lane j


def test_x2_weight_ring_serves_each_slice_its_rows():
    """Stage (18 i + s) mod w_stages carries packed rows 64 s .. 64 s + 63 of
    item i when the consumers read it, for every tile the tool takes."""
    for th, tg in ((8, 16), (4, 32), (2, 64)):
        for base in ("s2dc", "s2d9"):
            n = cf.wgmma_layout("s2d", base, th, tg)["w_stages"]
            held = {}
            for u in range(18 * 5):  # the producer runs at most n slices ahead
                held[u % n] = u % 18
                consumed = u - n + 1
                if consumed >= 0:
                    assert held[consumed % n] == consumed % 18


variants = importlib.import_module("deepfepe_tpu_torch.tools.xconv_variants")


@pytest.mark.parametrize("name", sorted(variants.VARIANTS))
def test_each_timing_variant_applies_to_the_kernel_source(name):
    """tools/xconv_variants.py replaces lines of csrc/conv_formulations.cu:
    each must still be there, once, so that a variant measures what it
    says."""
    src = variants.source(name)
    assert "conv_wgmma_kernel" in src
    assert (src == variants.source("base")) == (name == "base")


def test_the_timing_variants_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        variants.main(["--variants", "base"])
