"""Port parity: the eigensolvers (ops/jacobi, ops/eigh, the eigh9 wrapper).

`deepfepe_tpu_torch.ops.jacobi.jacobi_eigh` is the plain version of the
eigh9 kernel; it is held against `deepfepe_tpu.ops.jacobi.jacobi_eigh`,
the Pallas kernel's own reference, at the JAX test's bars in float32
(tests/test_jacobi.py: w 1e-5, |V| 1e-4) and at 1e-10 / 1e-8 in float64.
The kernels themselves run only on the card: their tests are in
tests/test_torch_eigh_card.py, which imports no JAX (both kernels bit for
bit against the plain version, the fused sort and sign fix, a NaN
matrix). On the CPU: the wrapper's routing by batch size and its argument
checks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.ops import eigh as j_eigh
from deepfepe_tpu.ops.jacobi import jacobi_eigh as j_jacobi
from deepfepe_tpu_torch.ops import eigh as t_eigh
from deepfepe_tpu_torch.ops import eigh9 as t_eigh9
from deepfepe_tpu_torch.ops.jacobi import jacobi_eigh as t_jacobi
from deepfepe_tpu_torch.utils import build
from _torch_threads import one_torch_thread  # noqa: F401

BARS = {"float32": (1e-5, 1e-4), "float64": (1e-10, 1e-8)}


def _sym(rng, b, n, dtype):
    A = rng.randn(b, n, n)
    return ((A + A.transpose(0, 2, 1)) / 2).astype(dtype)


def _gram(rng, b, rows, dtype):
    X = rng.randn(b, rows, 9)
    X /= np.linalg.norm(X, axis=-1, keepdims=True)
    return (X.transpose(0, 2, 1) @ X).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", [3, 9])
def test_jacobi_matches_jax(rng, dtype, n):
    A = _sym(rng, 16, n, dtype)
    wj, Vj = j_jacobi(jnp.asarray(A))
    wt, Vt = t_jacobi(torch.from_numpy(A))
    tol_w, tol_v = BARS[dtype]
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=tol_w, rtol=0)
    np.testing.assert_allclose(np.abs(Vt.numpy()), np.abs(np.asarray(Vj)), atol=tol_v, rtol=0)
    # Same sign convention, so the signed vectors agree too.
    np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=tol_v, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_jacobi_gram_batch_matches_jax(rng, dtype):
    """The path's inputs: Gram matrices of 8 rows (RANSAC minimal fits,
    rank 8) and of 200 rows (the DeepFNet solves)."""
    for rows in (8, 200):
        A = _gram(rng, 32, rows, dtype)
        wj, Vj = j_jacobi(jnp.asarray(A))
        wt, Vt = t_jacobi(torch.from_numpy(A))
        tol_w, tol_v = BARS[dtype]
        # The bar on w scales with the matrix (eigenvalues reach ~30 here).
        scale = np.abs(A).max()
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=tol_w * scale, rtol=0)
        # The null vector (the one the solver reads) is well separated.
        np.testing.assert_allclose(Vt.numpy()[..., 0], np.asarray(Vj)[..., 0], atol=tol_v)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_jacobi_degenerate_gram(rng, dtype):
    """Rank-deficient with repeated eigenvalues: the vectors are free within
    each repeated subspace, so compare eigenvalues and residuals."""
    lam = np.array([0.0, 0.0, 1.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0])
    Q = np.linalg.qr(rng.randn(9, 9))[0]
    A = np.stack([Q @ np.diag(lam) @ Q.T, np.diag(lam)]).astype(dtype)
    wj, _ = j_jacobi(jnp.asarray(A))
    wt, Vt = t_jacobi(torch.from_numpy(A))
    tol = 1e-5 if dtype == "float32" else 1e-10
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=tol)
    np.testing.assert_allclose(wt.numpy(), np.tile(lam, (2, 1)), atol=tol)
    V, w = Vt.double().numpy(), wt.double().numpy()
    resid = np.linalg.norm(A @ V - V * w[:, None, :], axis=(-1, -2))
    assert resid.max() < (1e-5 if dtype == "float32" else 1e-10)
    ortho = np.abs(V.transpose(0, 2, 1) @ V - np.eye(9)).max()
    assert ortho < (1e-5 if dtype == "float32" else 1e-10)


def test_safe_eigh_forward_and_backward_match_jax(rng):
    """The Lorentzian-broadened VJP, in float64 against jax.vjp."""
    A = _sym(rng, 4, 9, "float64")
    cw, cV = rng.randn(4, 9), rng.randn(4, 9, 9)

    (wj, Vj), vjp = jax.vjp(lambda a: j_eigh.safe_eigh(a), jnp.asarray(A))
    (gj,) = vjp((jnp.asarray(cw), jnp.asarray(cV)))

    At = torch.from_numpy(A).requires_grad_(True)
    wt, Vt = t_eigh.safe_eigh(At)
    ((wt * torch.from_numpy(cw)).sum() + (Vt * torch.from_numpy(cV)).sum()).backward()
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(wj), atol=1e-10)
    np.testing.assert_allclose(Vt.detach().numpy(), np.asarray(Vj), atol=1e-8)
    np.testing.assert_allclose(At.grad.numpy(), np.asarray(gj), atol=1e-7)


def test_safe_eigh_backward_bounded_at_degeneracy():
    A = torch.eye(3, dtype=torch.float64).repeat(2, 1, 1).requires_grad_(True)
    w, V = t_eigh.safe_eigh(A)
    (w.sum() + V.sum()).backward()
    assert torch.isfinite(A.grad).all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_smallest_singular_vec_gram_matches_jax(rng, dtype):
    X = rng.randn(3, 100, 9).astype(dtype)
    vj = j_eigh.smallest_singular_vec_gram(jnp.asarray(X))
    vt = t_eigh.smallest_singular_vec_gram(torch.from_numpy(X))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=BARS[dtype][1])


def test_eigh9_wrapper_runs_plain_version_on_cpu(rng):
    A = torch.from_numpy(_gram(rng, 5, 20, "float32"))
    before = t_eigh9.eigh9.launches
    w, V = t_eigh9.eigh9(A)
    wr, Vr = t_jacobi(A)
    assert torch.equal(w, wr) and torch.equal(V, Vr)
    assert t_eigh9.eigh9.launches == before


def test_eigh9_kernel_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="CUDA float32"):
        t_eigh9.launch(torch.zeros(4, 9, 9))
    with pytest.raises(ValueError, match="CUDA float32"):
        t_eigh9.eigh9(torch.zeros(4, 9, 9, device="meta"))


def test_eigh9_launch_rejects_an_unknown_kernel():
    with pytest.raises(ValueError, match="not one of"):
        t_eigh9.launch(torch.zeros(4, 9, 9), kernel="block")


@pytest.mark.parametrize("B,kernel", [(1, "warp"), (4, "warp"), (8, "warp"), (800, "warp"),
                                      ("crossover - 1", "warp"), ("crossover", "thread"),
                                      (4096, "thread")])
def test_eigh9_routes_small_batches_to_the_warp_kernel(B, kernel):
    """route(B) is a function of B alone: the solver's batches (4, 8, the
    sample loss's 800) take the warp kernel, RANSAC's 4096 the thread
    kernel, split at CROSSOVER_B."""
    crossover = t_eigh9.CROSSOVER_B
    B = {"crossover - 1": crossover - 1, "crossover": crossover}.get(B, B)
    assert 800 < crossover <= 4096
    assert t_eigh9.route(B) == kernel


def test_kernel_library_is_keyed_on_source_and_ignored_by_git():
    path = build.library_path("eigh9.cu")
    assert path == build.library_path("eigh9.cu")
    assert path.parent == build.BUILD_DIR and path.name.startswith("eigh9_")
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    repo = build.BUILD_DIR.parents[1]
    ignored = (repo / ".gitignore").read_text().split()
    assert "build/" in ignored


@pytest.mark.slow
def test_plain_version_matches_pallas_kernel_interpret(rng):
    from jax.experimental.pallas import tpu as pltpu

    from deepfepe_tpu.ops.pallas import eigh9_pallas

    A = _sym(rng, 8, 9, "float32")
    with pltpu.force_tpu_interpret_mode():
        w_p, V_p = eigh9_pallas(jnp.asarray(A), sweeps=7, tile=8)
    w_t, V_t = t_jacobi(torch.from_numpy(A))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_p), atol=1e-5)
    np.testing.assert_allclose(np.abs(V_t.numpy()), np.abs(np.asarray(V_p)), atol=1e-4)
