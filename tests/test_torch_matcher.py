"""Port parity: the mutual-NN matcher (kernel K4) and `mutual_nn_match`.

- The plain K4 (`mutual_nn_plain`, what the wrapper runs on the CPU)
  against JAX `mutual_nn_pallas` in interpret mode: nn12, nn21 and mutual
  identical, dist12 within 1e-5 (float32 sums in another order). The
  descriptors at K = 1024 are noisy copies with a third of the keypoints
  padded, so near-ties are rare; the cases with ties use sign vectors / 16
  (unit norm, every similarity an exact multiple of 2^-7 in any summation
  order), so ties are exact and must all go to the lowest index.
- `mutual_nn_match` on both routes ('xla', the masked plain path, and
  'pallas', K4 with the scores recomputed from the indices) against the
  JAX function on both backends: the same (pair, i, j) match sets and the
  same sorted scores within 1e-5.
- A valid pair whose best similarity is negative wins over every invalid
  keypoint on both routes (the additive -1e9 mask).
- Routing: 'auto' takes K4 only for a CUDA tensor with K >= 768, the JAX
  package's rule on the TPU; below it the plain route is that rule, not a
  fallback.
- K4's wrapper raises on what the kernel does not take, CPU tensors
  included. K4 itself against the plain version on the card is in
  tests/test_torch_cuda_kernels.py and tests/test_torch_matcher_card.py,
  which import no JAX: K = 1, 65 and 1000, exact ties straddling the
  kernel's tiles, every keypoint invalid.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepfepe_tpu.frontend.matching import mutual_nn_match as jmatch
from deepfepe_tpu.ops.pallas.matcher_pallas import mutual_nn_pallas
from deepfepe_tpu_torch.frontend import matching
from _torch_threads import one_torch_thread  # noqa: F401

matcher = importlib.import_module("deepfepe_tpu_torch.ops.matcher")


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _noisy(rng, B, K, D=256, frac_valid=0.7):
    base = rng.randn(B, K, D)
    d1, d2 = _unit(base), _unit(base + 0.3 * rng.randn(B, K, D))
    return d1, d2, rng.rand(B, K) < frac_valid, rng.rand(B, K) < frac_valid


def _signs(rng, B, K, D=256, frac_valid=0.8):
    """Unit sign vectors: every similarity is exact, ties are frequent."""
    d1 = (rng.choice([-1.0, 1.0], (B, K, D)) / np.sqrt(D)).astype(np.float32)
    d2 = (rng.choice([-1.0, 1.0], (B, K, D)) / np.sqrt(D)).astype(np.float32)
    return d1, d2, rng.rand(B, K) < frac_valid, rng.rand(B, K) < frac_valid


def _pairs(m):
    val, i1, i2 = (np.asarray(t) for t in (m.valid, m.idx1, m.idx2))
    return {(b, int(i1[b, k]), int(i2[b, k])) for b in range(val.shape[0])
            for k in range(val.shape[1]) if val[b, k]}


@pytest.mark.parametrize("case", ["noisy_1024", "signs_ties_300"])
def test_plain_kernel_matches_the_jax_kernel(case):
    rng = np.random.RandomState(3)
    args = _noisy(rng, 2, 1024) if case == "noisy_1024" else _signs(rng, 2, 300)
    want = [np.asarray(a) for a in mutual_nn_pallas(*map(jnp.asarray, args))]
    got = matcher.mutual_nn_kernel(*map(torch.from_numpy, args))
    for name, a, b in zip(("nn12", "nn21"), got[:2], want[:2]):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    if case == "signs_ties_300":
        # Ties are exact here: every argmax is the lowest index of its maxima.
        d1, d2, v1, v2 = args
        dot = d1.astype(np.float64) @ d2.transpose(0, 2, 1) + np.where(v2, 0, -1e9)[:, None]
        first = (dot == dot.max(-1, keepdims=True)).argmax(-1)
        assert (dot == dot.max(-1, keepdims=True)).sum(-1).max() > 1
        np.testing.assert_array_equal(got[0].numpy(), first)


@pytest.mark.parametrize("case", ["noisy_1024", "signs_ties_300"])
def test_mutual_nn_match_matches_jax_on_both_routes(case):
    rng = np.random.RandomState(5)
    args = _noisy(rng, 2, 1024) if case == "noisy_1024" else _signs(rng, 2, 300)
    targs = [torch.from_numpy(a) for a in args]
    ref = jmatch(*map(jnp.asarray, args), nn_thresh=1.3, backend="xla")
    ref_k = jmatch(*map(jnp.asarray, args), nn_thresh=1.3, backend="pallas")
    assert _pairs(ref) == _pairs(ref_k)
    for backend in ("xla", "pallas"):
        got = matching.mutual_nn_match(*targs, nn_thresh=1.3, backend=backend)
        assert _pairs(got) == _pairs(ref), backend
        np.testing.assert_allclose(np.sort(got.scores.numpy(), axis=None),
                                   np.sort(np.asarray(ref.scores), axis=None), atol=1e-5)
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


def test_negative_best_similarity_beats_invalid_keypoints():
    rng = np.random.RandomState(7)
    K, D = 40, 256
    v = _unit(rng.randn(D))
    d1 = _unit(rng.randn(1, K, D))
    d1[0, 0] = v
    d2 = _unit(-v + 0.3 * rng.randn(1, K, D))   # every valid column: similarity < 0
    invalid = np.arange(K) % 3 == 0
    d2[0, invalid] = _unit(v + 0.1 * rng.randn(int(invalid.sum()), D))  # near v, but padded
    v1, v2 = np.ones((1, K), bool), ~invalid[None]
    sims = d2[0] @ v
    assert sims[~invalid].max() < 0 < sims[invalid].min()
    want = int(np.flatnonzero(~invalid)[np.argmax(sims[~invalid])])
    targs = [torch.from_numpy(a) for a in (d1, d2, v1, v2)]
    assert int(matcher.mutual_nn_kernel(*targs)[0][0, 0]) == want
    for backend in ("xla", "pallas"):
        got = matching.mutual_nn_match(*targs, nn_thresh=2.0, backend=backend)
        ref = jmatch(*map(jnp.asarray, (d1, d2, v1, v2)), nn_thresh=2.0, backend=backend)
        assert _pairs(got) == _pairs(ref)
        assert all(not invalid[j] for _, _, j in _pairs(got))


def test_auto_routes_to_k4_only_on_the_card_at_k_768_and_above(monkeypatch):
    assert matching.PALLAS_MATCHER_MIN_K == 768
    assert matching.route("auto", True, 768) == "pallas"
    assert matching.route("auto", True, 767) == "xla"
    assert matching.route("auto", False, 4096) == "xla"
    assert matching.route("xla", True, 4096) == "xla"
    assert matching.route("pallas", False, 10) == "pallas"
    monkeypatch.setattr(matching, "DEFAULT_MATCHER_BACKEND", "xla")
    assert matching.route(None, True, 4096) == "xla"
    with pytest.raises(ValueError, match="not one of"):
        matching.route("cuda", True, 4096)


@pytest.mark.parametrize("case", ["shape", "dtype", "mask_dtype", "pairs", "device"])
def test_k4_launch_rejects_what_it_does_not_take(case):
    """K4's wrapper raises on what the kernel does not take, and on CPU
    tensors: it never falls back to the plain version."""
    d = torch.zeros(2, 10, 8)
    v = torch.ones(2, 10, dtype=torch.bool)
    args, match = {"shape": ((d, d[:, :9], v, v), r"\[B, K, D\]"),
                   "dtype": ((d.double(), d.double(), v, v), "float32"),
                   "mask_dtype": ((d, d, v.to(torch.uint8), v), "bool masks"),
                   "pairs": ((torch.zeros(matcher.MAX_B + 1, 1, 1),) * 2
                             + (torch.ones(matcher.MAX_B + 1, 1, dtype=torch.bool),) * 2,
                             "at most"),
                   "device": ((d, d, v, v), "CUDA tensors")}[case]
    before = matcher.mutual_nn_kernel.launches
    with pytest.raises(ValueError, match=match):
        matcher.launch(*args)
    assert matcher.mutual_nn_kernel.launches == before


def test_kernel_route_keeps_the_scores_differentiable():
    rng = np.random.RandomState(9)
    d1, d2, v1, v2 = (torch.from_numpy(a) for a in _noisy(rng, 1, 64, D=32, frac_valid=1.0))
    d1.requires_grad_(True)
    m = matching.mutual_nn_match(d1, d2, v1, v2, nn_thresh=2.0, backend="pallas")
    m.scores.sum().backward()
    assert torch.isfinite(d1.grad).all() and d1.grad.abs().sum() > 0
