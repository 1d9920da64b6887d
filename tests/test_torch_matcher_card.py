"""K4, the mutual-NN matcher kernel (`csrc/matcher.cu`), on the card
against its plain version `ops.matcher.mutual_nn_plain`.

This file imports torch and the port only, so it runs on a machine with
the card and without JAX or flax:

    python3 -m pytest tests/test_torch_matcher_card.py -m cuda -q

Every test is marked `cuda` and skips without a card; the card is looked
for inside the `cuda` fixture. The descriptors are sign vectors / 16 or
noisy copies made from numpy seeds: K = 1, 65 and 1000 bit for bit with
the plain version, exact ties straddling the kernel's 64-wide tiles going
to the lowest index, and every keypoint invalid.
"""

import importlib

import numpy as np
import pytest
import torch

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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 65, 1000])
def test_k4_matches_plain_at_ragged_sizes_on_card(cuda, K):
    """Sign vectors / 16: every similarity exact in any summation order, so
    the kernel equals the plain version bit for bit, ties included."""
    args = [torch.from_numpy(a).to(cuda) for a in _signs(np.random.RandomState(K), 2, K)]
    got = matcher.mutual_nn_kernel(*args)
    want = matcher.mutual_nn_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k4_ties_across_tiles_go_to_the_lowest_index_on_card(cuda):
    """Duplicated columns (60, 70, 130) and rows (5, 64, 190) straddle the
    kernel's 64-wide tiles: each duplicate's similarity is the same FMA
    chain, so the ties are exact and the lowest index wins both ways."""
    d1, d2, _, _ = _noisy(np.random.RandomState(11), 2, 200)
    d2[:, [70, 130]] = d2[:, [60]]
    d1[:, [5, 64, 190]] = d2[:, [60]]
    v = np.ones((2, 200), bool)
    nn12, nn21, _, mutual = matcher.mutual_nn_kernel(
        *(torch.from_numpy(a).to(cuda) for a in (d1, d2, v, v)))
    assert (nn12[:, [5, 64, 190]] == 60).all()
    assert (nn21[:, [60, 70, 130]] == 5).all()
    assert mutual[:, 5].all() and not mutual[:, [64, 190]].any()


@pytest.mark.cuda
def test_k4_all_invalid_pairs_on_card(cuda):
    """Every masked similarity rounds to -1e9: index 0 both ways, no mutual
    match, dist12 as the plain version's."""
    d1, d2, _, _ = _noisy(np.random.RandomState(13), 2, 300)
    v = np.zeros((2, 300), bool)
    args = [torch.from_numpy(a).to(cuda) for a in (d1, d2, v, v)]
    nn12, nn21, dist12, mutual = matcher.mutual_nn_kernel(*args)
    assert (nn12 == 0).all() and (nn21 == 0).all() and not mutual.any()
    assert torch.equal(dist12, matcher.mutual_nn_plain(*args)[2])
