"""Kernels on the card against their plain versions: K5 and K5b
(`csrc/conv3x3.cu`), K4 (`csrc/matcher.cu`) and K3 with its backward
(`csrc/epi_residual.cu`).

This file imports torch and the port only, so it runs on a machine with
the card and without JAX:

    python3 -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Every test is marked `cuda` and skips without a card. Inputs come from
numpy seeds.

- K5 at tests/test_conv_pallas.py's three shapes and a 64 -> 128 one:
  within 5e-5 of max(1, max|y|) of the plain version (that test's atol,
  for outputs of magnitude about 1-10; float32 sums in another order).
- K5b at the same shapes: dx, dw, dscale and dbias each within 1e-4 of
  the plain version's largest entry (tests/test_conv_pallas.py's bar for
  the gradients). With need_dx=False dx is exactly zero and dw within
  rtol = atol = 1e-5 of the plain version's (that file's need_dx test).
  Through autograd, the Function launches K5 once and K5b once and its
  gradients are the plain backward's on the same inputs.
- K5 and K5b at the SuperPoint path's ragged shapes, reduced in B
  (PATH_SHAPES), at the same bars; inc.conv0's Cin = 1 with
  need_dx=False (dx exactly zero); two K5b calls on the same inputs give
  bit-identical dw, dscale and dbias (a fixed summation order, no
  atomics).
- K4 on sign-vector descriptors (every similarity exact in any summation
  order, ties frequent): nn12, nn21, dist12 and mutual equal the plain
  version's exactly, ties to the lowest index.
- K3 at DeepFNet's, the F-loss's and the sample loss's shapes, reduced and
  full, and at a ragged one (M and N no multiple of a block's or a
  cluster's tile): the residual at tests/test_jacobi.py's bar (rtol 1e-4,
  atol 1e-5), each gradient within 1e-5 of its largest entry, the zero-row
  F's exactly 0; two calls bit-identical (fixed-order cluster sums);
  through `compute_epi_residual` at the three callers' broadcasts and F
  permuted in memory, with exact launch counts, against the plain version
  and its autograd; one device operation a forward and one a backward at
  the sample loss's pattern (torch.profiler); a pattern the strides cannot
  express raises.
"""

import importlib

import numpy as np
import pytest
import torch

conv = importlib.import_module("deepfepe_tpu_torch.ops.conv")
epi = importlib.import_module("deepfepe_tpu_torch.ops.epi_residual")
matcher = importlib.import_module("deepfepe_tpu_torch.ops.matcher")

CONV_SHAPES = [(2, 13, 17, 1, 64), (1, 16, 32, 64, 64), (3, 9, 21, 5, 8), (2, 40, 150, 64, 128)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=["cin1_pad", "aligned64", "odd_small", "c64to128"])
def test_k5_matches_plain_on_the_card(cuda, shape):
    B, H, W, Cin, C = shape
    rng = np.random.RandomState(0)
    args = (rng.randn(B, H, W, Cin), rng.randn(3, 3, Cin, C) * 0.1, rng.randn(C) * 0.5 + 1.0,
            rng.randn(C) * 0.1)
    x, w, s, t = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in args)
    with torch.no_grad():
        y = conv.conv3x3_affine_relu(x, w, s, t)
        ref = conv.conv3x3_affine_relu_ref(x, w, s, t)
    torch.cuda.synchronize()
    assert (y - ref).abs().max().item() <= 5e-5 * max(1.0, ref.abs().max().item())


def _bwd_inputs(shape, device, seed=0):
    """Forward inputs, the plain forward's y and a cotangent dy."""
    B, H, W, Cin, C = shape
    rng = np.random.RandomState(seed)
    args = (rng.randn(B, H, W, Cin), rng.randn(3, 3, Cin, C) * 0.1, rng.randn(C) * 0.5 + 1.0,
            rng.randn(C) * 0.1, rng.randn(B, H, W, C))
    x, w, s, t, dy = (torch.from_numpy(a.astype(np.float32)).to(device) for a in args)
    return x, w, s, t, conv.conv3x3_affine_relu_ref(x, w, s, t), dy


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=["cin1_pad", "aligned64", "odd_small", "c64to128"])
def test_k5b_matches_plain_on_the_card(cuda, shape):
    args = _bwd_inputs(shape, cuda)
    before = conv.conv3x3_affine_relu_bwd.launches
    got = conv.conv3x3_affine_relu_bwd(*args)
    want = conv.conv3x3_affine_relu_bwd_ref(*args)
    torch.cuda.synchronize()
    assert conv.conv3x3_affine_relu_bwd.launches == before + 1
    for name, a, b in zip(("dx", "dw", "dscale", "dbias"), got, want):
        assert a.shape == b.shape, name
        rel = (a - b).abs().max().item() / (b.abs().max().item() + 1e-9)
        assert rel < 1e-4, (name, rel)


@pytest.mark.cuda
def test_k5b_need_dx_false_on_the_card(cuda):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 12, 20, 1).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.randn(3, 3, 1, 8).astype(np.float32)).to(cuda)
    s, t = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    y = conv.conv3x3_affine_relu_ref(x, w, s, t)
    dy = torch.ones_like(y)
    dx, dw, _, _ = conv.conv3x3_affine_relu_bwd(x, w, s, t, y, dy, need_dx=False)
    _, dw_ref, _, _ = conv.conv3x3_affine_relu_bwd_ref(x, w, s, t, y, dy, need_dx=True)
    torch.cuda.synchronize()
    assert dx.abs().max().item() == 0.0
    torch.testing.assert_close(dw, dw_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_k5_k5b_through_autograd_on_the_card(cuda):
    x, w, s, t, _, dy = _bwd_inputs((2, 40, 150, 64, 128), cuda, seed=3)
    leaves = [a.clone().requires_grad_(True) for a in (x, w, s, t)]
    counts = conv.conv3x3_affine_relu.launches, conv.conv3x3_affine_relu_bwd.launches
    y = conv.conv3x3_affine_relu(*leaves)
    (y * dy).sum().backward()
    torch.cuda.synchronize()
    assert (conv.conv3x3_affine_relu.launches, conv.conv3x3_affine_relu_bwd.launches) == \
        (counts[0] + 1, counts[1] + 1)
    want = conv.conv3x3_affine_relu_bwd_ref(x, w, s, t, y.detach(), dy)
    for leaf, b in zip(leaves, want):
        rel = (leaf.grad - b).abs().max().item() / (b.abs().max().item() + 1e-9)
        assert rel < 1e-4, rel


# The path's shapes, reduced in B: H = 94 and W = 310 (down2) are not
# multiples of the kernels' 16 x 16 (forward, dx) or 4 x 32 (weight
# gradient) tiles, nor is a.conv1b's 120 x 160; Cin = 128 and C = 128 as at
# down2; Cin = 1 as at inc.conv0, whose input takes no gradient.
PATH_SHAPES = [(1, 94, 310, 64, 128), (1, 94, 310, 128, 128), (2, 120, 160, 64, 64),
               (1, 94, 310, 1, 64)]
PATH_IDS = ["down2_conv0", "down2_conv1", "a_conv1b", "inc_conv0"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PATH_SHAPES, ids=PATH_IDS)
def test_k5_at_the_path_shapes_on_the_card(cuda, shape):
    x, w, s, t, ref, _ = _bwd_inputs(shape, cuda, seed=5)
    with torch.no_grad():
        y = conv.conv3x3_affine_relu(x, w, s, t)
    torch.cuda.synchronize()
    assert (y - ref).abs().max().item() <= 5e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PATH_SHAPES, ids=PATH_IDS)
def test_k5b_at_the_path_shapes_on_the_card(cuda, shape):
    need_dx = shape[3] > 1
    args = _bwd_inputs(shape, cuda, seed=6)
    got = conv.conv3x3_affine_relu_bwd(*args, need_dx=need_dx)
    again = conv.conv3x3_affine_relu_bwd(*args, need_dx=need_dx)
    want = conv.conv3x3_affine_relu_bwd_ref(*args, need_dx=need_dx)
    torch.cuda.synchronize()
    if not need_dx:
        assert got[0].abs().max().item() == 0.0
    for name, a, b in list(zip(("dx", "dw", "dscale", "dbias"), got, want))[0 if need_dx else 1:]:
        assert a.shape == b.shape, name
        rel = (a - b).abs().max().item() / (b.abs().max().item() + 1e-9)
        assert rel < 1e-4, (name, rel)
    for name, a, b in zip(("dw", "dscale", "dbias"), got[1:], again[1:]):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("B,K", [(2, 1000), (4, 2048)])
def test_k4_matches_plain_on_the_card(cuda, B, K):
    rng = np.random.RandomState(B)
    D = 256
    d1, d2 = ((rng.choice([-1.0, 1.0], (B, K, D)) / np.sqrt(D)).astype(np.float32)
              for _ in range(2))
    v1, v2 = rng.rand(B, K) < 0.8, rng.rand(B, K) < 0.8
    args = [torch.from_numpy(a).to(cuda) for a in (d1, d2, v1, v2)]
    got = matcher.mutual_nn_kernel(*args)
    want = matcher.mutual_nn_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _epi_case(P, M, N, cuda, seed):
    """Points near the epipolar lines of a sideways translation, matrices
    that translation plus noise: some residuals clamped at 0.02, most not."""
    rng = np.random.RandomState(seed)
    x1 = np.concatenate([rng.uniform(-1, 1, (P, N, 2)), np.ones((P, N, 1))], -1)
    x2 = x1.copy()
    x2[..., 0] = rng.uniform(-1, 1, (P, N))
    x2[..., 1] += 0.01 * rng.randn(P, N)
    F = np.array([0.0, 0, 0, 0, 0, -1, 0, 1, 0]) + 0.002 * rng.randn(P, M, 9)
    F[0, 0, :6] = 0.0  # a zero-row F: (F x1)_xy = 0
    return [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (x1, x2, F)]


@pytest.mark.cuda
@pytest.mark.parametrize("P,M,N", [(3, 1, 1000), (2, 5, 100), (2, 130, 37)])
def test_k3_matches_plain_on_the_card(cuda, P, M, N):
    """K3 (csrc/epi_residual.cu) and its backward kernels against the plain
    versions on the card: the residual at tests/test_jacobi.py's bar for
    the Pallas kernel (rtol 1e-4, atol 1e-5), each gradient within 1e-5 of
    its largest entry (float32 sums of up to 1,000 terms in another order),
    the zero-row F's gradient exactly 0."""
    x1, x2, F9 = _epi_case(P, M, N, cuda, seed=M)
    g = torch.randn(P, M, N, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    d = epi.epi_residual_fwd(x1, x2, F9, 0.02, 1e-6)
    got = epi.epi_residual_bwd(x1, x2, F9, g, 0.02, 1e-6)
    want = epi.epi_residual_bwd_ref(x1, x2, F9, g, 0.02, 1e-6)
    ref = epi.epi_residual_ref(x1[:, None], x2[:, None], F9.view(P, M, 3, 3), 0.02)
    torch.cuda.synchronize()
    torch.testing.assert_close(d, ref, rtol=1e-4, atol=1e-5)
    assert 0.05 < (ref < 0.02).float().mean().item() < 0.95
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    assert got[0][0, 0].abs().max().item() == 0.0


@pytest.mark.cuda
def test_k3_through_compute_epi_residual_on_the_card(cuda):
    """The F-loss's broadcast through the route: one forward and one
    backward launch, gradients as the plain version's; a float64 CUDA
    tensor raises, never falls back."""
    from deepfepe_tpu_torch.geometry.epipolar import compute_epi_residual

    x1, x2, F9 = _epi_case(4, 3, 50, cuda, seed=7)
    pts1, pts2 = x1[None], x2[None]                      # [1, B, V, 3]
    F = F9.view(4, 3, 3, 3).transpose(0, 1).contiguous().requires_grad_()  # [L, B, 3, 3]
    counts = epi.epi_residual.launches, epi.epi_residual_bwd.launches
    out = compute_epi_residual(pts1, pts2, F, clamp_at=0.02)
    (gF,) = torch.autograd.grad(out.mean(), F)
    ref = epi.epi_residual_ref(pts1, pts2, F, 0.02)
    (gF_ref,) = torch.autograd.grad(ref.mean(), F)
    torch.cuda.synchronize()
    assert (epi.epi_residual.launches, epi.epi_residual_bwd.launches) == \
        (counts[0] + 1, counts[1] + 1)
    assert out.shape == (3, 4, 50)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    assert (gF - gF_ref).abs().max().item() <= 1e-5 * gF_ref.abs().max().item()
    with pytest.raises(ValueError, match="float32"):
        compute_epi_residual(pts1.double(), pts2.double(), F.detach().double())


@pytest.mark.cuda
@pytest.mark.parametrize("P,M,N", [(8, 1, 1000), (8, 5, 100), (8, 500, 100), (3, 517, 999),
                                   (8, 500, 400)])
def test_k3_at_the_path_and_ragged_shapes_on_the_card(cuda, P, M, N):
    """K3 and its backward at the paths' full shapes, and at ragged ones
    whose sums are split over clusters (M and N no multiple of a block's or
    a cluster's tile), against the plain versions at the first test's
    bars. Over a million residuals, float32 puts a few on the other side of
    a kink (|s| at s = 0, the clamp) in the kernel than in the plain
    version, each moving a gradient by about |g| (r1 + r2): those terms get
    no cotangent here, as the JAX comparisons give the kinks none."""
    x1, x2, F9 = _epi_case(P, M, N, cuda, seed=M)
    g = torch.randn(P, M, N, device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    F = F9.view(P, M, 3, 3)
    s = torch.sum(x2[:, None] * (x1[:, None] @ F.transpose(-1, -2)), dim=-1)
    d_free = epi.epi_residual_ref(x1[:, None], x2[:, None], F, float("inf"))
    kink = (s.abs() < 1e-6) | ((d_free - 0.02).abs() < 1e-5 * 0.02)
    assert kink.float().mean().item() < 1e-3
    g = g.masked_fill(kink, 0.0)
    d = epi.epi_residual_fwd(x1, x2, F9, 0.02, 1e-6)
    got = epi.epi_residual_bwd(x1, x2, F9, g, 0.02, 1e-6)
    want = epi.epi_residual_bwd_ref(x1, x2, F9, g, 0.02, 1e-6)
    ref = epi.epi_residual_ref(x1[:, None], x2[:, None], F, 0.02)
    torch.cuda.synchronize()
    torch.testing.assert_close(d, ref, rtol=1e-4, atol=1e-5)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()
    assert got[0][0, 0].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("P,M,N", [(8, 1, 1000), (8, 500, 100), (3, 517, 999)])
def test_k3_twice_bit_identical_on_the_card(cuda, P, M, N):
    """The backward's sums over the points (dF) and over the matrices (the
    points' gradients) are split over a cluster's blocks and added in rank
    order: two calls give the same bits, as does the forward."""
    x1, x2, F9 = _epi_case(P, M, N, cuda, seed=M + 1)
    g = torch.randn(P, M, N, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    first = (epi.epi_residual_fwd(x1, x2, F9, 0.02, 1e-6),
             *epi.epi_residual_bwd(x1, x2, F9, g, 0.02, 1e-6))
    second = (epi.epi_residual_fwd(x1, x2, F9, 0.02, 1e-6),
              *epi.epi_residual_bwd(x1, x2, F9, g, 0.02, 1e-6))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _caller(pattern, cuda, seed=3):
    """Points and F at a caller's broadcast (B = 4, V = 50, L = 3, S = 7),
    F a leaf (permuted_F: the sample loss's F held as [B, S, L, 3, 3],
    each 3x3 transposed), and a cotangent."""
    B, V, L, S = 4, 50, 3, 7
    M = {"deepfnet": 1, "f_loss": L}.get(pattern, L * S)
    x1, x2, F9 = _epi_case(B, M, V, cuda, seed)
    F = F9.view(B, M, 3, 3)
    if pattern == "deepfnet":
        pts1, pts2, F = x1, x2, F[:, 0]
    elif pattern == "f_loss":
        pts1, pts2, F = x1[None], x2[None], F.transpose(0, 1).contiguous()
    else:
        pts1, pts2 = x1[None, :, None], x2[None, :, None]
        F = F.view(B, L, S, 3, 3).transpose(0, 1).contiguous()
        if pattern == "permuted_F":
            F = F.permute(1, 2, 0, 4, 3).contiguous().permute(2, 0, 1, 4, 3)
    g = torch.randn(torch.broadcast_shapes(pts1.shape[:-1], F.shape[:-2] + (V,)), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(seed))
    return (*(t.detach().requires_grad_() for t in (pts1, pts2, F)), g)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["deepfnet", "f_loss", "sample", "permuted_F"])
def test_k3_caller_patterns_on_the_card(cuda, pattern):
    """Each caller's broadcast through `compute_epi_residual`: the kernels
    read F and the cotangent in place (F also permuted in memory), one
    launch each way; the residual at the forward's bar, its contiguous
    broadcast shape, and the three gradients within 1e-5 of the plain
    version's largest entry."""
    from deepfepe_tpu_torch.geometry.epipolar import compute_epi_residual

    pts1, pts2, F, g = _caller(pattern, cuda)
    counts = (epi.epi_residual.launches, epi.epi_residual_bwd.launches,
              epi.epi_residual_bwd.point_launches)
    out = compute_epi_residual(pts1, pts2, F, clamp_at=0.02)
    got = torch.autograd.grad(out, (pts1, pts2, F), g)
    ref = epi.epi_residual_ref(pts1, pts2, F, 0.02)
    want = torch.autograd.grad(ref, (pts1, pts2, F), g)
    torch.cuda.synchronize()
    assert (epi.epi_residual.launches, epi.epi_residual_bwd.launches,
            epi.epi_residual_bwd.point_launches) == tuple(c + 1 for c in counts)
    assert out.shape == ref.shape and out.is_contiguous()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.cuda
def test_k3_one_device_operation_each_way_on_the_card(cuda):
    """At the sample loss's pattern ([1, B, 1, V, 3] against [L, B, S, 3,
    3]) a forward call runs one device operation, the K3 kernel, and a
    backward call one, with the points' gradients too: no layout copies."""
    from deepfepe_tpu_torch.geometry.epipolar import compute_epi_residual
    from deepfepe_tpu_torch.tools.profile_epi import device_split

    pts1, pts2, F, g = _caller("sample", cuda)
    out = compute_epi_residual(pts1, pts2, F, clamp_at=0.02)
    calls = {"forward": lambda: compute_epi_residual(pts1, pts2, F, clamp_at=0.02),
             "dF": lambda: torch.autograd.grad(out, F, g, retain_graph=True),
             "all": lambda: torch.autograd.grad(out, (pts1, pts2, F), g, retain_graph=True)}
    for name, fn in calls.items():
        fn()
        split = device_split(fn, 1)
        assert split["device_ops"] == 1 and all("epi_" in k for k in split["split"]), \
            (name, split)


@pytest.mark.cuda
def test_k3_refuses_what_its_strides_cannot_express(cuda):
    """Three runs of matrix axes on the card raise; nothing falls back to
    the plain version."""
    from deepfepe_tpu_torch.geometry.epipolar import compute_epi_residual

    a = torch.ones(1, 2, 1, 3, 1, 5, 3, device=cuda)
    F = torch.zeros(2, 2, 3, 3, 2, 3, 3, device=cuda)
    with pytest.raises(ValueError):
        compute_epi_residual(a, a, F)
