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
  buffer, stride or layer order gives errors of order 1.
- Fused against unfused ErrorEstimator route at the same weights: the JAX
  bar of 3e-2 of the largest logit (test_mlp_pallas.py:72-90).
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


class _EmulatedLib:
    """The contract of each entry point of csrc/mlp.cu, in torch."""

    @staticmethod
    def mlp_gemm(A, B, C, bias, M, N, K, lda, ldb, ldc, a_t, b_t, splits, split_stride, s):
        a = _mem(A, torch.bfloat16, (M, K), (1, lda) if a_t else (lda, 1)).float()
        b = _mem(B, torch.bfloat16, (K, N), (1, ldb) if b_t else (ldb, 1)).float()
        kps = -(-(-(-K // splits)) // 32) * 32
        for z in range(splits):
            kb, ke = z * kps, min(K, (z + 1) * kps)
            res = a[:, kb:ke] @ b[kb:ke] if kb < ke else torch.zeros(M, N)
            if bias:
                res = res + _mem(bias, torch.float32, (N,), (1,))
            _mem(C + 4 * z * split_stride, torch.float32, (M, N), (ldc, 1)).copy_(res)
        return 0

    @staticmethod
    def mlp_sum_splits(part, out, mn, splits, s):
        _rows(out, torch.float32, 1, mn).copy_(
            _rows(part, torch.float32, splits, mn).sum(0, keepdim=True))
        return 0

    @staticmethod
    def mlp_cast_bf16(x, y, n, s):
        _rows(y, torch.bfloat16, 1, n).copy_(_rows(x, torch.float32, 1, n))
        return 0

    @staticmethod
    def mlp_in_stats(h, gamma, beta, mean, inv, scale, shift, Bt, Nn, C, s):
        hb = _bf(_mem(h, torch.float32, (Bt, Nn, C), (Nn * C, C, 1)))
        m = hb.sum(1) / Nn
        iv = torch.rsqrt(torch.clamp(_bf(hb * hb).sum(1) / Nn - m * m, min=0) + 1e-5)
        sc = _rows(gamma, torch.float32, 1, C) * iv
        for ptr, v in ((mean, m), (inv, iv), (scale, sc),
                       (shift, _rows(beta, torch.float32, 1, C) - m * sc)):
            _rows(ptr, torch.float32, Bt, C).copy_(v)
        return 0

    @staticmethod
    def mlp_in_apply(h, mean, inv, scale, shift, y, xhat, Bt, Nn, C, slope, s):
        hv = _mem(h, torch.float32, (Bt, Nn, C), (Nn * C, C, 1))
        st = [_rows(p, torch.float32, Bt, C)[:, None] for p in (mean, inv, scale, shift)]
        z = hv * st[2] + st[3]
        _mem(y, torch.bfloat16, (Bt, Nn, C), (Nn * C, C, 1)).copy_(
            torch.where(z >= 0, z, slope * z))
        if xhat:
            _mem(xhat, torch.bfloat16, (Bt, Nn, C), (Nn * C, C, 1)).copy_((hv - st[0]) * st[1])
        return 0

    @staticmethod
    def _dz(dy, xhat, gamma, beta, Bt, Nn, C, slope):
        d = _bf(_mem(dy, torch.float32, (Bt, Nn, C), (Nn * C, C, 1)))
        xh = _mem(xhat, torch.bfloat16, (Bt, Nn, C), (Nn * C, C, 1)).float()
        gb = _bf(_rows(gamma, torch.float32, 1, C))
        bb = _bf(_rows(beta, torch.float32, 1, C))
        zb = _bf(_bf(xh * gb) + bb)
        return torch.where(zb >= 0, d, _bf(float(_bf(torch.tensor(slope))) * d)), xh

    @classmethod
    def mlp_bwd_reduce(cls, dy, xhat, gamma, beta, inv, r1, r2, ab, c1b, c2b, Bt, Nn, C,
                       slope, s):
        dz, xh = cls._dz(dy, xhat, gamma, beta, Bt, Nn, C, slope)
        s1, s2 = dz.sum(1), _bf(dz * xh).sum(1)
        a = _rows(gamma, torch.float32, 1, C) * _rows(inv, torch.float32, Bt, C)
        for ptr, v in ((r1, s1), (r2, s2), (ab, _bf(a)), (c2b, _bf(a * (s2 / Nn))),
                       (c1b, _bf(a * (s1 / Nn)))):
            _rows(ptr, torch.float32, Bt, C).copy_(v)
        return 0

    @staticmethod
    def mlp_sum_items(r1, r2, dgamma, dbeta, Bt, C, s):
        _rows(dbeta, torch.float32, 1, C).copy_(_rows(r1, torch.float32, Bt, C).sum(0))
        _rows(dgamma, torch.float32, 1, C).copy_(_rows(r2, torch.float32, Bt, C).sum(0))
        return 0

    @classmethod
    def mlp_bwd_dh(cls, dy, xhat, gamma, beta, ab, c1b, c2b, dh, Bt, Nn, C, slope, s):
        dz, xh = cls._dz(dy, xhat, gamma, beta, Bt, Nn, C, slope)
        k = [_rows(p, torch.float32, Bt, C)[:, None] for p in (ab, c1b, c2b)]
        _mem(dh, torch.bfloat16, (Bt, Nn, C), (Nn * C, C, 1)).copy_(
            _bf(_bf(dz * k[0]) - _bf(xh * k[2])) - k[1])
        return 0

    @staticmethod
    def mlp_colsum_bf16(x, out, rows, C, s):
        _rows(out, torch.float32, 1, C).copy_(
            _rows(x, torch.bfloat16, rows, C).float().sum(0, keepdim=True))
        return 0


@pytest.fixture
def emulated(monkeypatch):
    """The kernels' wrappers over CPU tensors, through the emulated library."""
    monkeypatch.setattr(mlp, "_load", lambda: _EmulatedLib)
    monkeypatch.setattr(mlp, "_stream", lambda x: 0)
    monkeypatch.setattr(mlp, "_require_cuda", lambda x, ts: None)
    monkeypatch.setattr(mlp, "TARGET_BLOCKS", 8)  # split the short depth here too
    monkeypatch.setattr(mlp, "MIN_ROWS_PER_SPLIT", 16)


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
    Ws, gammas, betas, Wf, _ = p
    got = mlp.mlp_backward(x, g, Ws, gammas, betas, Wf)
    want = mlp.reference_pointnet_mlp_bwd(x, g, Ws, gammas, betas, Wf)
    flat = lambda r: [r[0], *r[1], *r[2], *r[3], r[4], r[5]]  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 5e-2 * b.abs().max().item(), b.shape
    assert (mlp.mlp_forward.launches - f0, mlp.mlp_backward.launches - b0) == (1, 1)


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


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "width", "chain"])
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
    else:
        Ws[2] = torch.zeros(FEATS[2], 7)
    with pytest.raises(ValueError):
        mlp._check_args(x, Ws, gammas, betas, Wf, bf)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the MLP kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("c_in", [5, 8])
def test_kernels_match_plain_on_the_card(cuda, c_in):
    rng = np.random.RandomState(20 + c_in)
    x = torch.from_numpy(rng.randn(3, 45, c_in).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.randn(3, 45, 1).astype(np.float32)).cuda()
    p = [t.cuda() if isinstance(t, torch.Tensor) else [u.cuda() for u in t]
         for t in _torch(_params(rng, c_in))]
    out, ref = mlp.mlp_forward(x, *p), mlp.reference_pointnet_mlp(x, *p)
    assert (out - ref).abs().max().item() < 2e-2 * ref.abs().max().item()
    got = mlp.mlp_backward(x, g, *p[:4])
    want = mlp.reference_pointnet_mlp_bwd(x, g, *p[:4])
    for a, b in zip([got[0], *got[1], got[4]], [want[0], *want[1], want[4]]):
        assert (a - b).abs().max().item() < 1.5e-1 * b.abs().max().item()


@pytest.mark.cuda
def test_cuda_tensors_of_wrong_dtype_shape_or_layout_raise(cuda):
    Ws, gammas, betas, Wf, bf = [t.cuda() if isinstance(t, torch.Tensor) else
                                 [u.cuda() for u in t]
                                 for t in _torch(_params(np.random.RandomState(6), 5))]
    x = torch.zeros(2, 10, 5, device="cuda")
    with pytest.raises(ValueError):
        mlp.mlp_forward(x.double(), Ws, gammas, betas, Wf, bf)
    with pytest.raises(ValueError):
        mlp.mlp_forward(x.transpose(0, 1), Ws, gammas, betas, Wf, bf)
    with pytest.raises(ValueError):
        mlp.fused_pointnet_mlp(x, [Ws[0].half(), *Ws[1:]], gammas, betas, Wf, bf)
    with pytest.raises(ValueError):
        mlp.fused_pointnet_mlp(x[..., :4], Ws, gammas, betas, Wf, bf)
