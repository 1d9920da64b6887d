"""K2 and K2b, the fused PointNet MLP kernels (`csrc/mlp.cu`), on the card
against their plain versions (`reference_pointnet_mlp`,
`reference_pointnet_mlp_bwd`).

This file imports torch and the port only, so it runs on a machine with
the card and without JAX or flax:

    python3 -m pytest tests/test_torch_mlp_card.py -m cuda -q

Every test is marked `cuda` and skips without a card; the card is looked
for inside the `cuda` fixture. At B = 3, N = 45 (64-row product tiles that
straddle items) and widths 16-24-32-24-16, C_in 5 and 8: the forward
within 2e-2 of the largest logit and dx, every dW and dWf within 1.5e-1
of their largest entry (the JAX package's bars, tests/test_mlp_pallas.py);
and the wrappers raise on CUDA tensors of a dtype, shape or layout the
kernels do not take.
"""

import importlib

import numpy as np
import pytest
import torch

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
