"""Port parity: the backward of the fused 3x3 conv + affine + ReLU (kernel
K5b) and the fused SuperPoint forward under grad.

- The plain backward (`conv3x3_affine_relu_bwd_ref`) and the autograd
  Function on the CPU against `jax.grad` of the JAX kernel
  `conv3x3_affine_relu(backend="pallas")` in interpret mode, at
  tests/test_conv_pallas.py's three shapes: dx, dw, dscale and dbias each
  within 1e-4 of the reference's largest entry (that test's bar: float32
  sums in another order). A channel whose scale is below 1e-8 follows the
  kernel's formula (its dscale divides by 1), not autograd of the plain
  forward.
- need_dx=False: dx exactly zero, dw within rtol = atol = 1e-5 of the
  reference's (tests/test_conv_pallas.py's need_dx test).
- A float64 `torch.autograd.gradcheck` of the Function's CPU path.
- The fused SuperPoint forward with every 3x3 layer on the Function (the
  pixel threshold set to 0, the conv switch on 'pallas'): its parameter
  gradients against the JAX fused forward's and the flax module's, each
  leaf within 1e-4 of the reference's largest entry (the bar of
  tests/test_conv_pallas.py's fused-gradient test). Running statistics
  get no gradient; the first conv declares no input gradient.
- `exact_convs` turns cuDNN, its TF32 and oneDNN off inside the
  block and restores all three after it.
- On a device other than the CPU the wrappers raise rather than fall back
  (the `meta` device stands in for a card here); the card's own checks are
  in tests/test_torch_cuda_kernels.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.frontend.sp_pallas import superpoint_forward_fused as jfused
from deepfepe_tpu.frontend.superpoint import SuperPointNetGauss2 as JGauss2
from deepfepe_tpu.ops.pallas.conv_pallas import conv3x3_affine_relu as jconv
from deepfepe_tpu.ops.pallas.conv_pallas import conv3x3_affine_relu_ref as jconv_ref
from deepfepe_tpu_torch.frontend import SuperPointNetGauss2
from deepfepe_tpu_torch.utils.weights import superpoint_state_from_flax
from _torch_threads import one_torch_thread  # noqa: F401

conv = importlib.import_module("deepfepe_tpu_torch.ops.conv")
sp_fused = importlib.import_module("deepfepe_tpu_torch.frontend.sp_fused")

SHAPES = [(2, 13, 17, 1, 64), (1, 16, 32, 64, 64), (3, 9, 21, 5, 8)]
IDS = ["cin1_pad", "aligned64", "odd_small"]
NAMES = ("dx", "dw", "dscale", "dbias")


def _inputs(shape, seed=0):
    B, H, W, Cin, C = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    w = (rng.randn(3, 3, Cin, C) * 0.1).astype(np.float32)
    s = (rng.randn(C) * 0.5 + 1.0).astype(np.float32)
    t = (rng.randn(C) * 0.1).astype(np.float32)
    cot = rng.randn(B, H, W, C).astype(np.float32)
    return x, w, s, t, cot


def _jax_grads(x, w, s, t, cot, need_dx=True):
    def loss(*a):
        return jnp.sum(jconv(*a, need_dx=need_dx, backend="pallas") * cot)

    return [np.asarray(g) for g in jax.grad(loss, (0, 1, 2, 3))(x, w, s, t)]


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_backward_matches_the_jax_kernel(shape):
    x, w, s, t, cot = _inputs(shape)
    s[0] = 0.0  # a dead channel: the kernel's dscale divides by 1 there
    want = _jax_grads(x, w, s, t, cot)
    tx, tw, ts, tt, tcot = map(torch.from_numpy, (x, w, s, t, cot))
    y = conv.conv3x3_affine_relu_ref(tx, tw, ts, tt)
    plain = conv.conv3x3_affine_relu_bwd_ref(tx, tw, ts, tt, y, tcot)
    leaves = [a.clone().requires_grad_(True) for a in (tx, tw, ts, tt)]
    before = conv.conv3x3_affine_relu_bwd.launches
    (conv.conv3x3_affine_relu(*leaves) * tcot).sum().backward()
    assert conv.conv3x3_affine_relu_bwd.launches == before  # the CPU runs the plain version
    for name, p, leaf, ref in zip(NAMES, plain, leaves, want):
        assert p.shape == ref.shape, name
        assert _rel(p.numpy(), ref) < 1e-4, (name, _rel(p.numpy(), ref))
        assert torch.equal(leaf.grad, p), name  # the Function's backward is the plain one


def test_dead_channel_dscale_follows_the_kernel():
    """|scale| < 1e-8: the kernel divides by 1, so dscale = sum dz = 0, where
    autograd of the plain forward gives sum dy * relu' * z."""
    x, w, s, t, cot = _inputs((1, 6, 7, 3, 4), seed=5)
    s[1], t[1] = 0.0, 0.5  # y = 0.5 everywhere on channel 1: the ReLU is open
    want = _jax_grads(x, w, s, t, cot)[2]
    tx, tw, ts, tt, tcot = map(torch.from_numpy, (x, w, s, t, cot))
    y = conv.conv3x3_affine_relu_ref(tx, tw, ts, tt)
    ds = conv.conv3x3_affine_relu_bwd_ref(tx, tw, ts, tt, y, tcot)[2]
    assert float(ds[1]) == 0.0 and float(want[1]) == 0.0
    np.testing.assert_allclose(ds.numpy(), want, atol=1e-4 * np.abs(want).max())
    autograd = jax.grad(lambda s: jnp.sum(jconv_ref(x, w, s, t) * cot))(s)
    assert abs(float(autograd[1])) > 1e-3


def test_need_dx_false_gives_zero_dx_and_the_same_dw():
    rng = np.random.RandomState(1)
    x = rng.randn(1, 12, 20, 1).astype(np.float32)
    w = rng.randn(3, 3, 1, 8).astype(np.float32)
    s, t = np.ones(8, np.float32), np.zeros(8, np.float32)
    gw0 = np.asarray(jax.grad(lambda w: jnp.sum(jconv_ref(x, w, s, t)))(w))
    tx, tw = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    conv.conv3x3_affine_relu(tx, tw, torch.from_numpy(s), torch.from_numpy(t),
                             need_dx=False).sum().backward()
    assert float(tx.grad.abs().max()) == 0.0
    np.testing.assert_allclose(tw.grad.numpy(), gw0, rtol=1e-5, atol=1e-5)


def test_gradcheck_float64():
    rng = np.random.RandomState(2)
    args = [torch.from_numpy(a).double().requires_grad_(True) for a in
            (rng.randn(2, 5, 6, 3), rng.randn(3, 3, 3, 4) * 0.3, rng.rand(4) + 0.5,
             rng.randn(4) * 0.1)]
    assert torch.autograd.gradcheck(lambda *a: conv.conv3x3_affine_relu(*a), args,
                                    eps=1e-6, atol=1e-6, rtol=1e-4)


def test_exact_convs_restores_the_flags():
    b = torch.backends
    saved = b.cudnn.enabled, b.cudnn.allow_tf32, b.mkldnn.enabled
    try:
        b.cudnn.enabled = b.cudnn.allow_tf32 = b.mkldnn.enabled = True
        with conv.exact_convs():
            assert (b.cudnn.enabled, b.cudnn.allow_tf32, b.mkldnn.enabled) == (False,) * 3
        assert (b.cudnn.enabled, b.cudnn.allow_tf32, b.mkldnn.enabled) == (True,) * 3
    finally:
        b.cudnn.enabled, b.cudnn.allow_tf32, b.mkldnn.enabled = saved


def test_off_cpu_the_backward_raises_and_never_falls_back():
    B, H, W, Cin, C = 1, 8, 8, 4, 8
    x, y, dy = (torch.empty(s, device="meta") for s in ((B, H, W, Cin), (B, H, W, C),
                                                        (B, H, W, C)))
    w, s, t = (torch.empty(s, device="meta") for s in ((3, 3, Cin, C), (C,), (C,)))
    with pytest.raises(ValueError, match="CUDA"):
        conv.conv3x3_affine_relu_bwd(x, w, s, t, y, dy)


def _gauss2_variables(shape, seed=2):
    """The JAX gauss2 net's variables as numpy, running statistics
    randomized (mean 0.1 N, variance |1 + 0.3 N| + 0.05, as
    tests/test_torch_frontend.py makes them)."""
    v = jax.tree_util.tree_map(np.asarray, JGauss2(dtype=jnp.float32).init(
        jax.random.PRNGKey(1), jnp.zeros(shape, jnp.float32)))
    rng = np.random.RandomState(seed)
    v = dict(v)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: ((0.1 * rng.randn(*a.shape)) if path[-1].key == "mean"
                         else np.abs(1 + 0.3 * rng.randn(*a.shape)) + 0.05).astype(np.float32),
        v["batch_stats"])
    return v


def test_fused_superpoint_param_grads_match_jax(monkeypatch):
    jnet = JGauss2(dtype=jnp.float32)
    x = np.random.RandomState(0).rand(1, 32, 48, 1).astype(np.float32)
    v = _gauss2_variables(x.shape)
    rng = np.random.RandomState(3)
    cot_semi = rng.randn(1, 4, 6, 65).astype(np.float32)
    cot_desc = rng.randn(1, 4, 6, 256).astype(np.float32)

    def loss(fn):
        def f(params):
            o = fn({"params": params, "batch_stats": v["batch_stats"]})
            return jnp.sum(o["semi"] * cot_semi) + jnp.sum(o["desc"] * cot_desc)
        return jax.jit(jax.grad(f))(v["params"])

    refs = {"flax": loss(lambda vv: jnet.apply(vv, x)),
            "jax_fused": loss(lambda vv: jfused(jnet, vv, jnp.asarray(x)))}
    net = SuperPointNetGauss2()
    net.load_state_dict(superpoint_state_from_flax(v), strict=True)
    monkeypatch.setattr(sp_fused, "MIN_PX_PALLAS", 0)
    calls = []
    real = conv.FusedConv3x3AffineReLU.apply
    monkeypatch.setattr(conv.FusedConv3x3AffineReLU, "apply",
                        lambda *a: calls.append(a[-1]) or real(*a))
    o = sp_fused.superpoint_forward_fused(net, torch.from_numpy(x), "pallas")
    (torch.sum(o["semi"] * torch.from_numpy(cot_semi))
     + torch.sum(o["desc"] * torch.from_numpy(cot_desc))).backward()
    assert calls == [False] + [True] * 9  # every 3x3 layer; the image needs no dx
    got = {k: p.grad for k, p in net.named_parameters()}
    assert all(g is not None for g in got.values())
    assert all(b.grad is None for b in net.buffers())
    for route, g in refs.items():
        want = superpoint_state_from_flax({"params": g, "batch_stats": v["batch_stats"]})
        for k, a in got.items():
            b = want[k].numpy()
            assert _rel(a.numpy(), b) < 1e-4, (route, k, _rel(a.numpy(), b))
