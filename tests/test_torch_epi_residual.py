"""Port parity: the robust epipolar residual (K3's function) and its
gradients.

The port's residual has two CPU routes: `compute_epi_residual` (the plain
version, differentiated by autograd) and the `EpiResidual` Function, which
on CPU tensors runs the kernels' plain versions in their [P, M, N] layout
and the backward kernels' formulas (`epi_residual_bwd_ref`). Both are held
against the JAX package at its three callers' broadcast patterns: DeepFNet
([B, N, 3] with [B, 3, 3]), the F-loss ([1, B, V, 3] with [L, B, 3, 3])
and the sample loss ([1, B, 1, V, 3] with [L, B, S, 3, 3]). Inputs come
from numpy seeds.

- Forward in float32 against JAX `compute_epi_residual` and against
  `epi_residual_pallas` in interpret mode, at tests/test_jacobi.py's bar
  for the Pallas kernel: rtol 1e-4, atol 1e-5.
- Gradients in float64 against `jax.grad` (points and F), within 1e-9 of
  the largest entry, on inputs that hold a zero-row F (tests/test_ops.py:
  229: (F x1)_xy is exactly 0, no gradient passes), an s = 0 and a residual
  exactly at the clamp (small powers of two: every step exact). At those
  two kinks the packages' conventions differ (JAX: |.|' = 1 at 0, clip
  passes 1/2 at the tie; torch: 0 and 1); the port's plain version and its
  kernels' formulas take torch's, held exactly against each other, and the
  JAX comparison gives those two points no cotangent.
- The kernels' CUDA versions are held against the plain versions on the
  card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.geometry.epipolar import compute_epi_residual as j_epi
from deepfepe_tpu_torch.geometry.epipolar import compute_epi_residual
from deepfepe_tpu_torch.tools import epi_variants
from _torch_threads import one_torch_thread  # noqa: F401

epi = importlib.import_module("deepfepe_tpu_torch.ops.epi_residual")

L, B, S, N = 3, 2, 4, 12
PATTERNS = {"deepfnet": ((B, N, 3), (B, 3, 3)),
            "f_loss": ((1, B, N, 3), (L, B, 3, 3)),
            "sample": ((1, B, 1, N, 3), (L, B, S, 3, 3))}
# Three more broadcasts the kernels' layout takes: the matrix axis inside
# the item axis, two matrix axes next to each other (merged into one run),
# and the sample loss's pattern with F permuted in memory ([L, B, S] held
# as [B, S, L], each 3x3 transposed: `_F_as_held`), read in place.
EXTRA = {"m_inner": ((B, 1, N, 3), (B, L, 3, 3)), "merged_m": ((1, 1, B, N, 3), (L, S, B, 3, 3)),
         "permuted_F": PATTERNS["sample"]}
ALL = {**PATTERNS, **EXTRA}
F_TIE = np.array([[0.0, 0, 0], [0, 0, -1], [0, 1, 0]])
# Point 1's residual against F_TIE, computed as both packages compute it.
TIE = 0.25 * (1.0 / (1.0 + 1e-6) + 1.0 / (1.0 + 1e-6))


def _inputs(pattern, seed=0, clamp=0.5):
    """Points in [-1, 1] homogeneous, x2 near x1's epipolar line of F_TIE,
    F = F_TIE + noise. The first F of the broadcast has zero rows; the last
    is F_TIE, against which point 0 (x1 = x2 = (0, 0, 1)) gives s = 0 and
    point 1 gives s = 0.25 and d = TIE exactly."""
    ps, fs = ALL[pattern]
    rng = np.random.RandomState(seed)
    x1 = np.concatenate([rng.uniform(-1, 1, ps[:-1] + (2,)), np.ones(ps[:-1] + (1,))], -1)
    x2 = x1.copy()
    x2[..., 0] = rng.uniform(-1, 1, ps[:-1])
    x2[..., 1] += 0.5 * clamp * rng.randn(*ps[:-1])
    F = F_TIE + 0.1 * clamp * rng.randn(*fs)
    Ff = F.reshape(-1, 3, 3)
    Ff[0, :2] = 0.0
    Ff[-1] = F_TIE
    x1[..., 0, :] = x2[..., 0, :] = [0.0, 0.0, 1.0]
    x1[..., 1, :], x2[..., 1, :] = [0.25, 0.5, 1.0], [0.75, 0.25, 1.0]  # s = 0.25 on F_TIE
    return x1, x2, F


def _port(route, a, b, F, clamp):
    if route == "plain":
        return compute_epi_residual(a, b, F, clamp_at=clamp)
    return epi.EpiResidual.apply(a, b, F, clamp, 1e-6)


@pytest.mark.parametrize("route", ["plain", "kernel_layout"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_residual_matches_jax_f32(pattern, route):
    x1, x2, F = (a.astype(np.float32) for a in _inputs(pattern, clamp=0.02))
    ref = np.asarray(j_epi(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(F), 0.02))
    got = _port(route, *(torch.from_numpy(a) for a in (x1, x2, F)), 0.02).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert 0.1 < np.mean(ref < 0.02) < 0.9  # clamped and unclamped residuals both occur


def test_residual_matches_pallas_interpret(rng):
    from jax.experimental.pallas import tpu as pltpu

    from deepfepe_tpu.ops.pallas import epi_residual_pallas

    x1, x2, F = (a.astype(np.float32) for a in _inputs("deepfnet", seed=1))
    F[0] = rng.randn(3, 3)  # the Pallas kernel's plain sqrt has no zero-norm guard
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(epi_residual_pallas(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(F),
                                             0.5))
    for route in ("plain", "kernel_layout"):
        got = _port(route, *(torch.from_numpy(a) for a in (x1, x2, F)), 0.5).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5, err_msg=route)


def _grads(route, x1, x2, F, clamp, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x1, x2, F)]
    out = _port(route, *ts, clamp)
    return out.detach(), [t.numpy() for t in torch.autograd.grad(out, ts, torch.from_numpy(g))]


def _cotangent(x1, F, seed=3):
    return np.random.RandomState(seed).randn(*np.broadcast_shapes(x1.shape[:-2], F.shape[:-2]),
                                             N)


@pytest.mark.parametrize("route", ["plain", "kernel_layout"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_gradients_match_jax_f64(pattern, route):
    """Every point off the two kinks (below) against jax.grad; the zero-row
    F passes no gradient at all."""
    x1, x2, F = _inputs(pattern, seed=2, clamp=TIE)
    g = _cotangent(x1, F)
    g.reshape(-1, N)[-1, :2] = 0.0  # the s = 0 and tie points: see the next test

    def jf(a, b, f):
        return jnp.sum(j_epi(a, b, f, TIE) * g)

    ref = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(F))
    _, got = _grads(route, x1, x2, F, TIE, g)
    for name, a, r in zip(("pts1", "pts2", "F"), got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a, r, rtol=0, atol=1e-9 * np.abs(r).max(), err_msg=name)
    assert np.all(got[2].reshape(-1, 3, 3)[0] == 0)  # every residual of the zero-row F is clamped


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_gradients_at_the_kinks(pattern):
    """At s = 0 and at d == clamp_at the port takes torch's conventions, in
    its plain version and in the kernels' formulas alike: |s| passes no
    gradient at 0, and the clamp passes all of it at the tie (JAX's
    jnp.abs passes 1 at 0 and its clip 1/2 at the tie, on a set of measure
    zero of the path's float inputs)."""
    x1, x2, F = _inputs(pattern, seed=2, clamp=TIE)
    g = _cotangent(x1, F)
    out, plain = _grads("plain", x1, x2, F, TIE, g)
    _, layout = _grads("kernel_layout", x1, x2, F, TIE, g)
    for a, b in zip(plain, layout):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12 * np.abs(a).max())
    last = out.reshape(-1, N)[-1]
    assert last[0].item() == 0.0 and last[1].item() == TIE
    for point, clamp_ref in ((0, TIE), (1, 1e30)):
        only = np.zeros_like(g)
        only.reshape(-1, N)[-1, point] = 1.0
        for route in ("plain", "kernel_layout"):
            got = _grads(route, x1, x2, F, TIE, only)[1]
            want = _grads("plain", x1, x2, F, clamp_ref, only)[1]  # the tie: as if unclamped
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
                if point == 0:
                    assert not a.any()  # |s|'(0) = 0, and |s| = 0 zeroes the norms' terms


def test_zero_row_F_gradient_is_finite():
    """tests/test_ops.py:229's case through both routes: F with zero rows
    gives (F x1)_xy = 0, whose norm has no gradient; the result's gradient
    is finite and equals JAX's."""
    F = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.4e6, 1.3e5, -3.0e5]])
    rng = np.random.RandomState(0)
    p1 = np.concatenate([rng.uniform(-1, 1, (50, 2)), np.ones((50, 1))], -1)
    p2 = np.concatenate([rng.uniform(-1, 1, (50, 2)), np.ones((50, 1))], -1)
    ref = jax.grad(lambda f: jnp.mean(j_epi(jnp.asarray(p1), jnp.asarray(p2), f, 0.02)))(
        jnp.asarray(F))
    for route in ("plain", "kernel_layout"):
        f = torch.from_numpy(F).requires_grad_()
        val = _port(route, torch.from_numpy(p1), torch.from_numpy(p2), f, 0.02).mean()
        (gF,) = torch.autograd.grad(val, f)
        assert torch.isfinite(val) and torch.isfinite(gF).all()
        np.testing.assert_array_equal(gF.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shapes", [((2, 5, 3), (1, 3, 3)), ((3, 2, 5, 3), (2, 3, 3)),
                                    ((1, 5, 3), (2, 3, 3))])
def test_layout_raises_for_other_patterns(shapes):
    """The kernels' layout takes every batch axis of the points from F; F
    broadcast over the points (or over a point axis of another size) is not
    a pattern of the path and raises (the plain version computes it)."""
    ps, fs = shapes
    a, F = torch.zeros(ps), torch.zeros(fs)
    if ps[0] == 1 and fs[0] == 2:  # a pattern the layout takes: P = 1, M = 2
        assert epi.layout(a, a, F).P == 1 and epi.layout(a, a, F).M == 2
        return
    with pytest.raises(ValueError):
        epi.layout(a, a, F)
    assert compute_epi_residual(a + 1, a + 1, F).shape == torch.broadcast_shapes(
        ps[:-1], fs[:-2] + (ps[-2],))


def test_layout_maps_the_sample_loss_pattern_without_expanding_points():
    """The sample loss's [L, B, S] matrices against [B] points: P = B and
    two matrix runs, L and S, addressed by F's own strides; the residual
    and its cotangent [L, B, S, N] and dF in F's shape by theirs."""
    a = torch.zeros(1, B, 1, N, 3)
    F = torch.randn(L, B, S, 3, 3)
    lay = epi.layout(a, a, F)
    assert (lay.P, lay.MH, lay.ML, lay.M, lay.N) == (B, L, S, L * S, N)
    assert lay.points(a, lay.p1).shape == (B, N, 3)
    F9 = lay.matrices(F).reshape(B, L * S, 9)
    assert torch.equal(F9[1, 2 * S + 3], F[2, 1, 3].reshape(9))
    out = torch.arange(B * L * S * N, dtype=torch.float32).reshape(B, L * S, N)
    res = torch.empty(lay.out_shape)
    lay.rows(res, lay.o).copy_(out.view(B, L, S, N))
    assert res.shape == (L, B, S, N) and res[2, 1, 3, 5] == out[1, 2 * S + 3, 5]
    g, _, o = lay.cotangent(res)
    assert g is res and torch.equal(lay.rows(g, o).reshape(B, L * S, N), out)
    dF = torch.empty(lay.F_shape)
    lay.F_grad_rows(dF).copy_(F9.view(B, L, S, 3, 3))
    assert torch.equal(dF, F)


def test_cpu_routes_launch_no_kernel():
    before = (epi.epi_residual.launches, epi.epi_residual_bwd.launches)
    x1, x2, F = (torch.from_numpy(a).requires_grad_() for a in _inputs("f_loss"))
    for out in (compute_epi_residual(x1, x2, F), epi.EpiResidual.apply(x1, x2, F, 0.5, 1e-6)):
        out.sum().backward()
    assert (epi.epi_residual.launches, epi.epi_residual_bwd.launches) == before


def _F_as_held(pattern, F: torch.Tensor) -> torch.Tensor:
    """F as the pattern holds it in memory: permuted_F's is a view of a
    [B, S, L, 3, 3] tensor with each 3x3 transposed (same values)."""
    if pattern != "permuted_F":
        return F
    return F.permute(1, 2, 0, 4, 3).contiguous().permute(2, 0, 1, 4, 3)


def _copying_layout(pts_shape, F_shape):
    """What the layout did before it took strides: F and the cotangent
    permuted (the points' axes first, then F's own) and copied into [P, M,
    9] and [P, M, N]; the residual permuted back."""
    nb = max(len(pts_shape), len(F_shape)) - 2
    ps = (1,) * (nb - len(pts_shape) + 2) + tuple(pts_shape[:-2])
    fs = (1,) * (nb - len(F_shape) + 2) + tuple(F_shape[:-2])
    order = [i for i in range(nb) if ps[i] == fs[i]] + [i for i in range(nb) if ps[i] != fs[i]]
    P = int(np.prod([fs[i] for i in order if ps[i] == fs[i]]))
    M = int(np.prod(fs)) // P
    Nn = pts_shape[-2]
    lead = tuple(fs[i] for i in order)
    inverse = [order.index(i) for i in range(nb)]
    return {
        "matrices": lambda F: F.reshape(fs + (3, 3)).permute(*order, nb, nb + 1)
        .reshape(P, M, 9).contiguous(),
        "cotangent": lambda g: g.permute(*order, nb).reshape(P, M, Nn).contiguous(),
        "residual": lambda out: out.reshape(lead + (Nn,)).permute(*inverse, nb),
        "P": P, "M": M}


@pytest.mark.parametrize("pattern", sorted(ALL))
def test_layout_strides_match_the_copying_layout(pattern):
    """The strides, applied with torch.as_strided to F's, the cotangent's
    and the outputs' storage, address exactly what the copying layout
    produced: F, the cotangent, the residual and dF, at the callers'
    patterns and three more."""
    x1, _, F = _inputs(pattern)
    x1, F = torch.from_numpy(x1), _F_as_held(pattern, torch.from_numpy(F))
    lay = epi.layout(x1, x1, F)
    old = _copying_layout(x1.shape, F.shape)
    P, M = old["P"], old["M"]
    assert (lay.P, lay.M, lay.N) == (P, M, N)
    assert torch.equal(lay.matrices(F).reshape(P, M, 9), old["matrices"](F))
    assert torch.equal(lay.points(x1, lay.p1), x1.reshape(P, N, 3))
    g = torch.from_numpy(_cotangent(x1.numpy(), F.numpy()))
    g_k, _, o = lay.cotangent(g)
    assert g_k is g and torch.equal(lay.rows(g, o).reshape(P, M, N), old["cotangent"](g))
    flat = torch.arange(P * M * N, dtype=torch.float64).reshape(P, M, N)
    res = torch.empty(lay.out_shape, dtype=torch.float64)
    lay.rows(res, lay.o).copy_(flat.view(P, lay.MH, lay.ML, N))
    assert res.is_contiguous() and torch.equal(res, old["residual"](flat))
    dF = torch.empty(lay.F_shape, dtype=torch.float64)
    lay.F_grad_rows(dF).copy_(old["matrices"](F).view(P, lay.MH, lay.ML, 3, 3))
    assert torch.equal(dF, F)
    assert len([r for r in lay.runs[1:] if r]) == (2 if pattern in ("sample", "permuted_F")
                                                   else 1 if M > 1 else 0)


@pytest.mark.parametrize("pattern", sorted(EXTRA))
def test_extra_patterns_match_jax(pattern):
    """Through the kernels' layout on the CPU at the three more patterns:
    the forward in float32 at the callers' bar (rtol 1e-4, atol 1e-5), the
    gradients in float64 within 1e-9 of the largest entry (the two kinks'
    points given no cotangent, as in test_gradients_match_jax_f64)."""
    x1, x2, F = (a.astype(np.float32) for a in _inputs(pattern, clamp=0.02))
    ref = np.asarray(j_epi(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(F), 0.02))
    got = epi.EpiResidual.apply(torch.from_numpy(x1), torch.from_numpy(x2),
                                _F_as_held(pattern, torch.from_numpy(F)), 0.02, 1e-6)
    assert got.shape == ref.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)

    x1, x2, F = _inputs(pattern, seed=2, clamp=TIE)
    g = _cotangent(x1, F)
    g.reshape(-1, N)[-1, :2] = 0.0
    jref = jax.grad(lambda a, b, f: jnp.sum(j_epi(a, b, f, TIE) * g), argnums=(0, 1, 2))(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(F))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x1, x2, F)]
    out = epi.EpiResidual.apply(ts[0], ts[1], _F_as_held(pattern, ts[2]), TIE, 1e-6)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for name, a, r in zip(("pts1", "pts2", "F"), got, jref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=1e-9 * np.abs(r).max(),
                                   err_msg=name)


def test_cpu_route_makes_no_copy_of_F(monkeypatch):
    """The Function's CPU route hands the plain version a strided view of
    F's own storage, as the kernel reads F: no copy, at the sample loss's
    pattern with F permuted in memory too."""
    seen = []
    ref = epi.epi_residual_ref

    def spy(a, b, f, *args):
        seen.append(f)
        return ref(a, b, f, *args)

    monkeypatch.setattr(epi, "epi_residual_ref", spy)
    for pattern in ("sample", "permuted_F"):
        x1, x2, F = (torch.from_numpy(a) for a in _inputs(pattern))
        F = _F_as_held(pattern, F)
        epi.EpiResidual.apply(x1, x2, F, 0.5, 1e-6)
        view = seen[-1]
        assert view.shape == (B, L, S, 3, 3)
        assert view.untyped_storage().data_ptr() == F.untyped_storage().data_ptr()
        assert torch.equal(view, F.permute(1, 0, 2, 3, 4))


def test_layout_raises_past_two_matrix_runs_and_max_work():
    """Three matrix runs ([L, B, S, B2, T] matrices against [B, B2] points)
    are more than the kernels' strides express: the layout raises, the plain
    version computes them. So does a call past MAX_WORK residuals."""
    a = torch.zeros(1, 2, 1, 3, 1, N, 3)
    F = torch.zeros(2, 2, 3, 3, 2, 3, 3)
    with pytest.raises(ValueError, match="two of matrix axes"):
        epi.layout(a, a, F)
    assert compute_epi_residual(a + 1, a + 1, F).shape == (2, 2, 3, 3, 2, N)
    pts = torch.zeros(1, 1, 1, 1).expand(2**11, 1, 2**10, 3)  # shapes and strides only
    with pytest.raises(ValueError, match="at most"):
        epi.layout(pts, pts, torch.zeros(1, 1, 1, 1).expand(2**11, 2**11, 3, 3))


def test_cotangent_strides_used_in_place_or_copied():
    """A cotangent whose strides address the runs is read in place, an
    expanded one (stride 0, as a mean's backward can hand back) too; one
    laid out otherwise is copied contiguous, and the backward gives the
    same gradients for all three."""
    x1, x2, F = (torch.from_numpy(a) for a in _inputs("merged_m", seed=4))
    lay = epi.layout(x1, x2, F)
    g = torch.from_numpy(_cotangent(x1.numpy(), F.numpy()))
    expanded = torch.full((1, 1, 1, 1), 0.5, dtype=torch.float64).expand(g.shape)
    odd = g.transpose(0, 1).contiguous().transpose(0, 1)  # [L, S, B, N] held as [S, L, B, N]
    assert lay.cotangent(g)[0] is g and lay.cotangent(expanded)[0] is expanded
    copied = lay.cotangent(odd)[0]
    assert copied is not odd and copied.is_contiguous() and torch.equal(copied, g)
    for g_as_held, g_copy in ((odd, g), (expanded, expanded.contiguous())):
        got = epi.backward(lay, x1, x2, F, g_as_held, 0.5, 1e-6)
        for a, b in zip(got, epi.backward(lay, x1, x2, F, g_copy, 0.5, 1e-6)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(epi_variants.VARIANTS))
def test_each_timing_variant_applies_to_the_kernel_source(name):
    """tools/epi_variants.py replaces lines of csrc/epi_residual.cu: each
    must still be there, once, so that a variant measures what it says;
    variants joined by '+' apply in turn."""
    src = epi_variants.source(name)
    assert "epi_bwd_kernel" in src
    assert (src == epi_variants.source("base")) == (name == "base")
    if name != "base":
        both = epi_variants.source(f"{name}+base")
        assert both == src


def test_the_timing_variants_need_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert epi_variants.main(["--variants", "base"]) == 2


def test_the_profiler_witness_needs_the_card(monkeypatch):
    from deepfepe_tpu_torch.tools import profiler_witness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiler_witness.main(["t"]) == 2
