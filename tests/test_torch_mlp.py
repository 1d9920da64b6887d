"""Port parity: the fused PointNet MLP (kernels K2 and K2b) and its route
in the ErrorEstimator.

Inputs are made with numpy from a seed at small widths; weights cross in
the port's Linear layout ([out, in]) and the JAX kernel layout ([in, out]).

- Plain forward against JAX `reference_pointnet_mlp`, the same math:
  1e-5 of the largest logit (measured 1.1e-7). Against JAX
  `fused_pointnet_mlp` in interpret mode, as tests/test_mlp_pallas.py runs
  it: 3e-2, the JAX package's bar for its fused route
  (test_mlp_pallas.py:90). That kernel differs from its own reference by
  up to 2.2% of the largest logit at these inputs (measured, C_in = 5),
  above the 2e-2 its forward test holds at other inputs: XLA keeps excess
  precision between the bf16 ops, and a bf16 ulp (2^-8) of a hidden
  activation is amplified over five normalized layers.
- Plain backward against the VJP of JAX `fused_pointnet_mlp`: the JAX bar
  of 1.5e-1 of each gradient's largest entry (its bf16 transients).
- The kernels' launch sequence, run on the CPU through an emulation of the
  C interface of csrc/mlp.cu (each entry point's contract written in
  torch over the same pointers), against the plain versions: 1e-2 of the
  largest entry forward and 5e-2 backward. Sums run in another order than
  the plain version's, which moves bf16 roundings by an ulp; a wrong
  buffer, stride or layer order gives errors of order 1. The launches a
  call are counted (2L + 2 forward, 5L + 3 backward).
- The wrappers' host-side geometry: which items each 64-row tile holds
  (tiles that straddle items included), the first layer's zero padding
  to 16 columns (exact products), and the fold of tile partials in the
  kernels' order against the plain per-item sums (1e-5 relative).
- Fused against unfused ErrorEstimator route at the same weights: the JAX
  bar of 3e-2 of the largest logit (test_mlp_pallas.py:72-90).
- The kernels on the card: tests/test_torch_mlp_card.py, which imports no
  JAX.
- `chip_smoke.exact_pointnet_mlp`, the float64 stack the card's checks
  hold K2 and K2b against, equals autograd of the unfused ErrorEstimator
  in float64 on the same bf16-valued input and weights (hidden biases
  zero) to 1e-12, relative.
"""

import ctypes
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.ops.pallas.mlp_pallas import fused_pointnet_mlp as jfused
from deepfepe_tpu.ops.pallas.mlp_pallas import reference_pointnet_mlp as jreference
from deepfepe_tpu_torch.models import ErrorEstimator

mlp = importlib.import_module("deepfepe_tpu_torch.ops.mlp")

FEATS = (16, 24, 32, 24, 16)


def _params(rng, c_in, feats=FEATS, out=1):
    """Float32 parameters in the port's Linear layout."""
    Ws, gammas, betas, c = [], [], [], c_in
    for f in feats:
        Ws.append(rng.randn(f, c).astype(np.float32) * 0.3)
        gammas.append((rng.rand(f) + 0.5).astype(np.float32))
        betas.append((rng.randn(f) * 0.1).astype(np.float32))
        c = f
    Wf = rng.randn(out, c).astype(np.float32) * 0.3
    bf = (rng.randn(out) * 0.1).astype(np.float32)
    return Ws, gammas, betas, Wf, bf


def _torch(p):
    Ws, gammas, betas, Wf, bf = p
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return [t(w) for w in Ws], [t(g) for g in gammas], [t(b) for b in betas], t(Wf), t(bf)


def _jax(p):
    Ws, gammas, betas, Wf, bf = p
    return ([jnp.asarray(w.T) for w in Ws], [jnp.asarray(g) for g in gammas],
            [jnp.asarray(b) for b in betas], (jnp.asarray(Wf.T), jnp.asarray(bf)))


@pytest.mark.parametrize("c_in", [5, 8])
def test_plain_forward_matches_jax(c_in):
    rng = np.random.RandomState(c_in)
    x = rng.randn(3, 50, c_in).astype(np.float32)
    p = _params(rng, c_in)
    out = mlp.reference_pointnet_mlp(torch.from_numpy(x), *_torch(p)).numpy()
    jfu = np.asarray(jfused(jnp.asarray(x), *_jax(p)))[..., :1]
    jre = np.asarray(jreference(jnp.asarray(x), *_jax(p)))
    assert out.shape == (3, 50, 1)
    scale = np.abs(jre).max()
    assert np.abs(out - jre).max() < 1e-5 * scale
    assert np.abs(out - jfu).max() < 3e-2 * scale


def test_plain_backward_matches_jax_kernel_vjp():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 40, 5).astype(np.float32)
    g = rng.randn(2, 40, 1).astype(np.float32)
    p = _params(rng, 5)
    Ws, gammas, betas, Wfbf = _jax(p)
    _, vjp = jax.vjp(lambda *a: jfused(*a)[..., :1], jnp.asarray(x), Ws, gammas, betas, Wfbf)
    jdx, jdW, jdg, jdb, (jdWf, jdbf) = vjp(jnp.asarray(g))
    tW, tg, tb, tWf, _ = _torch(p)
    dx, dW, dg, db, dWf, dbf = mlp.reference_pointnet_mlp_bwd(
        torch.from_numpy(x), torch.from_numpy(g), tW, tg, tb, tWf)
    pairs = [(dx, jdx), (dWf, np.asarray(jdWf).T), (dbf, jdbf)]
    pairs += [(a, np.asarray(b).T) for a, b in zip(dW, jdW)]
    pairs += list(zip(dg, jdg)) + list(zip(db, jdb))
    for ours, ref in pairs:
        ref = np.asarray(ref)
        assert ours.shape == ref.shape
        rel = np.abs(ours.numpy() - ref).max() / (np.abs(ref).max() + 1e-8)
        assert rel < 1.5e-1, (ref.shape, rel)


# ---------------------------------------------------------------------------
# The kernels' launch sequence, with the C interface emulated on the CPU
# ---------------------------------------------------------------------------


def _mem(ptr, dtype, shape, strides):
    """A tensor over raw host memory at `ptr`."""
    numel = 1 + sum((n - 1) * s for n, s in zip(shape, strides))
    size = torch.tensor([], dtype=dtype).element_size()
    buf = (ctypes.c_char * (numel * size)).from_address(ptr)
    return torch.frombuffer(buf, dtype=dtype, count=numel).as_strided(shape, strides)


def _rows(ptr, dtype, rows, cols):
    return _mem(ptr, dtype, (rows, cols), (cols, 1))


def _bf(t):
    return t.to(torch.bfloat16).float()


def _leaky(z, slope):
    return torch.where(z >= 0, z, slope * z)


def _items(rows, n_points):
    return torch.arange(rows) // n_points


def _tile_slot(rows, n_points):
    """Each row's 64-row tile and its slot there: the row's item less the
    tile's first item."""
    r = torch.arange(rows)
    t = r // 64
    return t, r // n_points - (64 * t) // n_points


def _write_partials(p1, p2, v1, v2, n_points, slots):
    """Per (tile, slot) column sums of v1, v2 [rows, C] into [tiles][slots][C]."""
    rows, C = v1.shape
    t, s = _tile_slot(rows, n_points)
    tiles = -(-rows // 64)
    for ptr, v in ((p1, v1), (p2, v2)):
        acc = torch.zeros(tiles * slots, C).index_add_(0, t * slots + s, v)
        _rows(ptr, torch.float32, tiles * slots, C).copy_(acc)


def _dz(dy, xh, gamma, beta, slope):
    """dz of a layer from dy (rounded to bf16) and its ReLU mask."""
    gb, bb = _bf(gamma), _bf(beta)
    zb = _bf(_bf(xh * gb) + bb)
    d = _bf(dy)
    return torch.where(zb >= 0, d, _bf(float(_bf(torch.tensor(slope))) * d))


class _EmulatedLib:
    """The contract of each entry point of csrc/mlp.cu, in torch. `calls`
    counts the launches by name."""

    def __init__(self):
        self.calls = []

    def __getattribute__(self, name):
        if name.startswith("mlp_"):
            object.__getattribute__(self, "calls").append(name)
        return object.__getattribute__(self, name)

    @staticmethod
    def mlp_pack(table, nseg, s):
        for src, dst, rows, sc, dc in _rows(table, torch.int64, nseg, 5).tolist():
            out = _rows(dst, torch.bfloat16, rows, dc)
            out.zero_()
            out[:, :sc] = _rows(src, torch.float32, rows, sc)
        return 0

    @staticmethod
    def mlp_gemm_fwd(a, scale, shift, mean, inv, stash_y, stash_xhat, w, h, part1, part2,
                     M, N, K, Nn, slots, slope, s):
        if scale:
            hp = _rows(a, torch.float32, M, K)
            nb, it = -(-M // Nn), _items(M, Nn)
            st = [_rows(q, torch.float32, nb, K)[it] if q else None
                  for q in (scale, shift, mean, inv)]
            y = _bf(_leaky(hp * st[0] + st[1], slope))
            if stash_y:
                _rows(stash_y, torch.bfloat16, M, K).copy_(y)
                _rows(stash_xhat, torch.bfloat16, M, K).copy_((hp - st[2]) * st[3])
        else:
            y = _rows(a, torch.bfloat16, M, K).float()
        out = y @ _rows(w, torch.bfloat16, N, K).float().T
        _rows(h, torch.float32, M, N).copy_(out)
        hb = _bf(out)
        _write_partials(part1, part2, hb, _bf(hb * hb), Nn, slots)
        return 0

    @staticmethod
    def mlp_fold(mode, p1, p2, gamma, beta, inv, o0, o1, o2, o3, rsum, B, Nn, C, slots,
                 src0, dst0, e0, n0, src1, dst1, e1, n1, s):
        if mode >= 0:
            tiles = -(-B * Nn // 64)
            P = [_mem(q, torch.float32, (tiles, slots, C), (slots * C, C, 1)) for q in (p1, p2)]
            s1, s2 = (_fold_items(q, B, Nn) for q in P)
            g = _rows(gamma, torch.float32, 1, C)
            if mode == 0:
                m = s1 / Nn
                iv = torch.rsqrt(torch.clamp(s2 / Nn - m * m, min=0) + 1e-5)
                sc = g * iv
                vals = [m, iv, sc, _rows(beta, torch.float32, 1, C) - m * sc]
                outs = (o0, o1, o2, o3)
            else:
                a = g * _rows(inv, torch.float32, B, C)
                vals = [_bf(a), _bf(a * (s1 / Nn)), _bf(a * (s2 / Nn))]
                outs = (o0, o1, o2)
                _rows(rsum, torch.float32, B, 2 * C).copy_(torch.cat([s1, s2], 1))
            for ptr, v in zip(outs, vals):
                if ptr:
                    _rows(ptr, torch.float32, B, C).copy_(v)
        for src, dst, e, n in ((src0, dst0, e0, n0), (src1, dst1, e1, n1)):
            if n:
                _rows(dst, torch.float32, 1, e).copy_(
                    _rows(src, torch.float32, n, e).sum(0, keepdim=True))
        return 0

    @staticmethod
    def mlp_final_fwd(h, scale, shift, wf, bias, out, M, C, n_out, Nn, slope, s):
        it = _items(M, Nn)
        nb = -(-M // Nn)
        sc, sh = (_rows(q, torch.float32, nb, C)[it] for q in (scale, shift))
        y = _bf(_leaky(_rows(h, torch.float32, M, C) * sc + sh, slope))
        _rows(out, torch.float32, M, n_out).copy_(
            y @ _rows(wf, torch.bfloat16, n_out, C).float().T + _rows(bias, torch.float32, 1, n_out))
        return 0

    @staticmethod
    def mlp_final_bwd(h, mean, inv, scale, shift, gamma, beta, g, wf, xhat, dz, part1, part2,
                      part_gf, M, C, n_out, Nn, slots, slope, s):
        it, nb, tiles = _items(M, Nn), -(-M // Nn), -(-M // 64)
        mu, iv, sc, sh = (_rows(q, torch.float32, nb, C)[it] for q in (mean, inv, scale, shift))
        hh = _rows(h, torch.float32, M, C)
        xh = _bf((hh - mu) * iv)
        y = _bf(_leaky(hh * sc + sh, slope))
        gb = _bf(_rows(g, torch.float32, M, n_out))
        d = _dz(gb @ _rows(wf, torch.bfloat16, n_out, C).float(), xh,
                _rows(gamma, torch.float32, 1, C), _rows(beta, torch.float32, 1, C), slope)
        _rows(xhat, torch.bfloat16, M, C).copy_(xh)
        _rows(dz, torch.bfloat16, M, C).copy_(d)
        _write_partials(part1, part2, d, _bf(d * xh), Nn, slots)
        t = torch.arange(M) // 64
        dwf = torch.zeros(tiles, n_out, C)
        dbf = torch.zeros(tiles, n_out)
        for k in range(tiles):
            dwf[k] = gb[t == k].T @ y[t == k]
            dbf[k] = gb[t == k].sum(0)
        _rows(part_gf, torch.float32, tiles, n_out * C + n_out).copy_(
            torch.cat([dwf.view(tiles, -1), dbf], 1))
        return 0

    @staticmethod
    def _dh(dz, xhat, ab, c1b, c2b, rows, C, Nn):
        it, nb = _items(rows, Nn), -(-rows // Nn)
        a, k1, k2 = (_rows(q, torch.float32, nb, C)[it] for q in (ab, c1b, c2b))
        d = _rows(dz, torch.bfloat16, rows, C).float()
        xh = _rows(xhat, torch.bfloat16, rows, C).float()
        return _bf(_bf(_bf(d * a) - _bf(xh * k2)) - k1)

    @classmethod
    def mlp_gemm_dw(cls, dz, xhat, ab, c1b, c2b, dh, x_in, ldx, part, rows, cout, cin, Nn, per,
                    splits, s):
        d = cls._dh(dz, xhat, ab, c1b, c2b, rows, cout, Nn)
        _rows(dh, torch.bfloat16, rows, cout).copy_(d)
        xv = _rows(x_in, torch.bfloat16, rows, ldx)[:, :cin].float()
        assert per % 64 == 0 and splits * per >= rows > (splits - 1) * per
        for z in range(splits):
            r = slice(z * per, min(rows, (z + 1) * per))
            _rows(part + 4 * z * cout * cin, torch.float32, cout, cin).copy_(d[r].T @ xv[r])
        return 0

    @staticmethod
    def mlp_gemm_dy(dh, w, ldw, xhat_prev, gamma_prev, beta_prev, dz_prev, part1, part2, dx,
                    rows, cout, cin, Nn, slots, slope, s):
        d = _rows(dh, torch.bfloat16, rows, cout).float()
        dy = d @ _rows(w, torch.bfloat16, cout, ldw)[:, :cin].float()
        if not xhat_prev:
            _rows(dx, torch.float32, rows, cin).copy_(dy)
            return 0
        xh = _rows(xhat_prev, torch.bfloat16, rows, cin).float()
        dz = _dz(dy, xh, _rows(gamma_prev, torch.float32, 1, cin),
                 _rows(beta_prev, torch.float32, 1, cin), slope)
        _rows(dz_prev, torch.bfloat16, rows, cin).copy_(dz)
        _write_partials(part1, part2, dz, _bf(dz * xh), Nn, slots)
        return 0


def _item_tiles(b, n_points):
    """(tile, slot) of each tile that holds item b's rows, in the order the
    fold adds them; slot s of a tile is the item of its first row plus s."""
    t0, t1 = b * n_points // 64, ((b + 1) * n_points - 1) // 64
    return [(t, b - 64 * t // n_points) for t in range(t0, t1 + 1)]


def _fold_items(part, B, n_points):
    """The per-item sums [B, C] of tile partials [tiles, slots, C], added in
    csrc/mlp.cu's fold order: lane k of 32 adds the item's tiles k, k + 32,
    ... in order, then the lanes are added in order."""
    out = torch.zeros((B, part.shape[-1]), dtype=part.dtype)
    for b in range(B):
        pairs = _item_tiles(b, n_points)
        for k in range(32):
            lane = torch.zeros(part.shape[-1], dtype=part.dtype)
            for t, s in pairs[k::32]:
                lane += part[t, s]
            out[b] += lane
    return out


@pytest.fixture
def emulated(monkeypatch):
    """The kernels' wrappers over CPU tensors, through the emulated library."""
    lib = _EmulatedLib()
    monkeypatch.setattr(mlp, "_load", lambda: lib)
    monkeypatch.setattr(mlp, "_stream", lambda x: 0)
    monkeypatch.setattr(mlp, "_require_cuda", lambda x, ts: None)
    monkeypatch.setattr(mlp, "TARGET_BLOCKS", 8)  # split the short depth here too
    return lib


@pytest.mark.parametrize("c_in", [5, 8])
def test_kernel_launch_sequence_matches_plain(emulated, c_in):
    rng = np.random.RandomState(10 + c_in)
    x = torch.from_numpy(rng.randn(3, 45, c_in).astype(np.float32))
    g = torch.from_numpy(rng.randn(3, 45, 1).astype(np.float32))
    p = _torch(_params(rng, c_in))
    f0, b0 = mlp.mlp_forward.launches, mlp.mlp_backward.launches
    out = mlp.mlp_forward(x, *p)
    ref = mlp.reference_pointnet_mlp(x, *p)
    assert np.abs((out - ref).numpy()).max() < 1e-2 * ref.abs().max().item()
    L = len(FEATS)
    assert len(emulated.calls) == 2 * L + 2  # pack, a product and a fold a layer, final
    Ws, gammas, betas, Wf, _ = p
    got = mlp.mlp_backward(x, g, Ws, gammas, betas, Wf)
    want = mlp.reference_pointnet_mlp_bwd(x, g, Ws, gammas, betas, Wf)
    assert len(emulated.calls) == 2 * L + 2 + 5 * L + 3
    flat = lambda r: [r[0], *r[1], *r[2], *r[3], r[4], r[5]]  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 5e-2 * b.abs().max().item(), b.shape
    assert (mlp.mlp_forward.launches - f0, mlp.mlp_backward.launches - b0) == (1, 1)


@pytest.mark.parametrize("B,N", [(3, 45), (3, 1000), (8, 1000), (2, 64), (4, 7)])
def test_tiles_and_items(B, N):
    """Each item's (tile, slot) pairs, in the fold's order, against the
    items the rows of each 64-row tile hold; the slots bound every tile."""
    rows = B * N
    seen = {b: [] for b in range(B)}
    most = 0
    for t in range(-(-rows // 64)):
        items = sorted({r // N for r in range(64 * t, min(rows, 64 * t + 64))})
        most = max(most, len(items))
        for s, b in enumerate(items):
            seen[b].append((t, s))
    assert most <= mlp.tile_slots(N, B)
    for b in range(B):
        assert _item_tiles(b, N) == seen[b]
    if N % 64:  # tiles straddle items
        assert most > 1


@pytest.mark.parametrize("c_in", [5, 8, 16, 17])
def test_first_layer_k_padding(emulated, c_in):
    """x and W_0 are padded with zero columns to a multiple of 16, and the
    padded product is the unpadded one."""
    cp = mlp.pad_k(c_in)
    assert cp % 16 == 0 and c_in <= cp < c_in + 16
    rng = np.random.RandomState(c_in)
    x = torch.from_numpy(rng.randn(2, 30, c_in).astype(np.float32))
    Ws, gammas, betas, Wf, bf = _torch(_params(rng, c_in, feats=(16, 8)))
    dims = mlp._check_args(x, Ws, gammas, betas, Wf, bf)
    ws = mlp._Workspace("cpu", [("xp", None, 2 * 60 * cp), ("w", None, mlp._packed_bytes(dims))])
    run = mlp._Launcher(emulated, 0)
    Wp = mlp._pack(run, x, Ws, Wf, dims, ws)
    assert emulated.calls == ["mlp_pack"]
    xp = _rows(ws.xp, torch.bfloat16, 60, cp).float()
    W0 = _rows(Wp[0], torch.bfloat16, 16, cp).float()
    assert (xp[:, c_in:] == 0).all() and (W0[:, c_in:] == 0).all()
    assert torch.equal(xp[:, :c_in], _bf(x.view(60, c_in)))
    assert torch.equal(W0[:, :c_in], _bf(Ws[0]))
    assert torch.allclose(xp @ W0.T, _bf(x.view(60, c_in)) @ _bf(Ws[0]).T, rtol=1e-6, atol=1e-6)
    assert torch.equal(_rows(Wp[1], torch.bfloat16, 8, 16).float(), _bf(Ws[1]))
    assert torch.equal(_rows(Wp[2], torch.bfloat16, 1, 8).float(), _bf(Wf))


@pytest.mark.parametrize("B,N", [(3, 45), (3, 1000), (2, 64)])
def test_fold_of_tile_partials_matches_item_sums(emulated, B, N):
    """Tile partials of bf16(h) and bf16(h)^2, as the products' epilogue
    writes them, folded in the kernels' order: the plain version's per-item
    sums, and through the emulated fold its mean and inv."""
    rng = np.random.RandomState(B * N)
    C = 24
    h = torch.from_numpy(rng.randn(B * N, C).astype(np.float32) * 3 + 1)
    hb = _bf(h)
    slots, tiles = mlp.tile_slots(N, B), -(-B * N // 64)
    part = torch.zeros(2, tiles * slots * C)
    _write_partials(part[0].data_ptr(), part[1].data_ptr(), hb, _bf(hb * hb), N, slots)
    want1 = hb.view(B, N, C).sum(1)
    want2 = _bf(hb * hb).view(B, N, C).sum(1)
    for k, want in ((0, want1), (1, want2)):
        got = _fold_items(part[k].view(tiles, slots, C), B, N)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-4)
    gamma, beta = torch.ones(C), torch.zeros(C)
    st = torch.empty(4, B * C)
    ptr = lambda ts: [t.data_ptr() for t in ts]  # noqa: E731
    mlp._Launcher(emulated, 0)("mlp_fold", 0, *ptr(part), *ptr([gamma, beta]), None,
                               *ptr(st), None, B, N, C, slots, None, None, 0, 0, None, None, 0, 0)
    mean = want1 / N
    inv = torch.rsqrt(torch.clamp(want2 / N - mean * mean, min=0) + 1e-5)
    assert torch.allclose(st[0].view(B, C), mean, rtol=1e-5, atol=1e-5)
    assert torch.allclose(st[1].view(B, C), inv, rtol=1e-4)


# ---------------------------------------------------------------------------
# The ErrorEstimator's fused route
# ---------------------------------------------------------------------------


def _estimators(c_in, feats=FEATS, seed=0):
    std = ErrorEstimator(c_in, 1, features=feats, dtype=torch.bfloat16)
    fus = ErrorEstimator(c_in, 1, features=feats, dtype=torch.bfloat16, use_fused=True)
    std.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # non-trivial affines and biases
        for m in std.fw[1:-1:3]:
            m.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(seed + 1))
            m.bias.uniform_(-0.2, 0.2, generator=torch.Generator().manual_seed(seed + 2))
        std.fw[-1].bias.fill_(0.1)
    fus.load_state_dict(std.state_dict(), strict=True)
    return std, fus


def test_fused_route_matches_unfused_at_same_weights():
    std, fus = _estimators(7)
    assert list(std.state_dict()) == list(fus.state_dict())
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 40, 7).astype(np.float32))
    with torch.no_grad():
        o_std, o_fus = std(x), fus(x)
    assert o_fus.shape == o_std.shape == (2, 40, 1) and o_fus.dtype == torch.float32
    scale = o_std.abs().max().item()
    assert (o_std - o_fus).abs().max().item() < 3e-2 * scale


def test_hidden_bias_gradient_is_exact_zero_in_fused():
    _, fus = _estimators(5, feats=(8, 12))
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 30, 5).astype(np.float32))
    fus(x).sum().backward()
    for i in range(2):
        grad = fus.fw[3 * i].bias.grad
        assert grad is None or float(grad.abs().max()) == 0.0
    assert float(fus.fw[-1].bias.grad.abs().max()) > 0.0
    assert float(fus.fw[0].weight.grad.abs().max()) > 0.0


def test_fused_route_only_for_bf16_narrow_inputs(monkeypatch):
    calls = []
    monkeypatch.setattr(importlib.import_module("deepfepe_tpu_torch.models.error_estimator"),
                        "fused_pointnet_mlp", lambda *a: calls.append(1))
    f32 = ErrorEstimator(5, 1, features=(8,), dtype=torch.float32, use_fused=True)
    wide = ErrorEstimator(129, 1, features=(8,), dtype=torch.bfloat16, use_fused=True)
    f32(torch.zeros(1, 4, 5))
    wide(torch.zeros(1, 4, 129))
    assert calls == []
    ErrorEstimator(5, 1, features=(8,), dtype=torch.bfloat16, use_fused=True)(
        torch.zeros(1, 4, 5))
    assert calls == [1]


def test_float64_reference_of_the_card_checks_is_the_unfused_stack():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.rand(2, 30, 5).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 30, 1).astype(np.float32))
    Ws, gammas, betas, Wf, bf = _torch(_params(rng, 5))
    _, *grads = smoke.exact_pointnet_mlp(x, g, Ws, gammas, betas, Wf, bf)

    est = ErrorEstimator(5, 1, features=FEATS, dtype=torch.float64).double()
    bf16 = lambda t: t.to(torch.bfloat16).double()  # noqa: E731
    with torch.no_grad():
        for i in range(len(FEATS)):
            est.fw[3 * i].weight.copy_(bf16(Ws[i]))
            est.fw[3 * i].bias.zero_()
            est.fw[3 * i + 1].weight.copy_(gammas[i])
            est.fw[3 * i + 1].bias.copy_(betas[i])
        est.fw[-1].weight.copy_(bf16(Wf))
        est.fw[-1].bias.copy_(bf)
    xb = bf16(x).requires_grad_(True)
    est(xb).backward(g.double())
    L = len(FEATS)
    want = [xb.grad, [est.fw[3 * i].weight.grad for i in range(L)],
            [est.fw[3 * i + 1].weight.grad for i in range(L)],
            [est.fw[3 * i + 1].bias.grad for i in range(L)], est.fw[-1].weight.grad,
            est.fw[-1].bias.grad]
    for a, b in zip(smoke.flat_grads(grads), smoke.flat_grads(want)):
        assert float((a - b).norm() / b.norm()) < 1e-12


# ---------------------------------------------------------------------------
# The wrappers' argument checks
# ---------------------------------------------------------------------------


def test_kernel_wrappers_raise_on_cpu_tensors():
    rng = np.random.RandomState(4)
    p = _torch(_params(rng, 5))
    x = torch.zeros(2, 10, 5)
    with pytest.raises(ValueError, match="CUDA"):
        mlp.mlp_forward(x, *p)
    with pytest.raises(ValueError, match="CUDA"):
        mlp.mlp_backward(x, torch.zeros(2, 10, 1), *p[:4])


def test_profile_tool_needs_the_card(monkeypatch, capsys):
    tool = importlib.import_module("deepfepe_tpu_torch.tools.profile_mlp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--B", "8"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "width", "chain", "odd_width",
                                  "last_width"])
def test_argument_checks(case):
    rng = np.random.RandomState(5)
    Ws, gammas, betas, Wf, bf = _torch(_params(rng, 5))
    x = torch.zeros(2, 10, 5)
    if case == "dtype":
        x = x.double()
    elif case == "shape":
        x = x[0]
    elif case == "contiguity":
        x = torch.zeros(2, 5, 10).transpose(1, 2)
    elif case == "width":
        x = torch.zeros(2, 10, 129)
        Ws[0] = torch.zeros(FEATS[0], 129)
    elif case == "chain":
        Ws[2] = torch.zeros(FEATS[2], 7)
    elif case == "odd_width":  # hidden widths are whole 16-byte rows of bf16
        Ws[1], gammas[1], betas[1] = torch.zeros(20, FEATS[0]), torch.ones(20), torch.zeros(20)
        Ws[2] = torch.zeros(FEATS[2], 20)
    else:  # the final passes take a last hidden layer of at most 1024
        Ws[-1], gammas[-1], betas[-1] = (torch.zeros(1032, FEATS[-2]), torch.ones(1032),
                                         torch.zeros(1032))
        Wf = torch.zeros(1, 1032)
    with pytest.raises(ValueError):
        mlp._check_args(x, Ws, gammas, betas, Wf, bf)
