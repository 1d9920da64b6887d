"""Port parity: SuperPoint training (`frontend/train_sp.py`).

- `SyntheticShapes`, `CornerTextures`, `sample_homography`, `warp_labels`
  and `corners_to_cells` equal the JAX package's bit for bit for the same
  seeds (the same numpy code and draw order).
- `detector_loss` and `descriptor_loss` (dense, and `hard_neg` 4) in value
  and input gradient, float64: 1e-9.
- One step of each of the four step builders from the same weights
  (`superpoint_state_from_flax`) and batch: the losses and every parameter
  gradient in float64 to 1e-9 (relative to the leaf's largest entry, or
  1e-4 where that is smaller), then the
  parameters after the Adam step (to 1e-9, relative above 1); the gauss2 BN step's running buffers;
  an eval-mode-BN step (the port has no `freeze_batch_stats_grads`: torch
  BatchNorm buffers take no gradient) leaves the buffers as they were.
  The JAX steps run under `superpoint_float64` (its float32 casts lifted)
  with an optimizer that applies `optax.adam` and keeps the gradient in
  its state, all in one module fixture.
- `homographic_adaptation` (2 images at 64x96, 3 views) to 1e-9, and
  `heatmap_to_cells` equal.
The test homographies keep every warped cell centre at least 1e-6 px^2
off the correspondence boundary d2 = 16, so both packages see the same
positives.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepfepe_tpu.frontend import train_sp as jt
from deepfepe_tpu.frontend.superpoint import (SuperPointNet as JSuperPointNet,
                                              SuperPointNetGauss2 as JGauss2)
from deepfepe_tpu_torch.frontend import SuperPointNet, SuperPointNetGauss2
from deepfepe_tpu_torch.frontend import train_sp as tt
from deepfepe_tpu_torch.ops.conv import step_convs
from deepfepe_tpu_torch.utils.weights import superpoint_state_from_flax

from _torch_joint_setup import superpoint_float64
from test_torch_frontend import flax_variables
from _torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-9
SIZE = (48, 64)
B = 2
LR = 1e-3
STEPS = ("detector", "detector_bn", "joint", "warped_joint")
HARD_NEG = {"joint": 4, "warped_joint": 0}


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), rtol=tol, atol=tol)


def _leaf_close(want, got, what, floor=1e-4):
    """Relative to the leaf's largest entry, floored: a gradient whose true
    value is 0 (a conv bias before train-mode BatchNorm) is rounding only,
    and Adam scales that rounding up to lr |dg| / eps in the update."""
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.detach().numpy()  # no gradient: zero
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: {err} against max {scale}"


def off_boundary(H, size=SIZE, cell=8, margin=1e-6):
    """Every warped cell centre's d2 to every centre is `margin` or more
    away from (cell / 2)^2."""
    Hc, Wc = size[0] // cell, size[1] // cell
    ys, xs = np.meshgrid(np.arange(Hc), np.arange(Wc), indexing="ij")
    c = np.stack([xs * cell + cell / 2, ys * cell + cell / 2, np.ones_like(xs)], -1).reshape(-1, 3)
    w = np.einsum("bij,nj->bni", np.asarray(H, np.float64), c)
    w = w[..., :2] / w[..., 2:]
    d2 = ((w[:, :, None] - c[None, None, :, :2]) ** 2).sum(-1)
    return float(np.abs(d2 - (cell / 2) ** 2).min()) >= margin


def make_batch(seed=0, textures=False):
    """A warped-pair batch at SIZE from the JAX package's generators (the
    tools' make_batch)."""
    ds = (jt.CornerTextures(image_size=SIZE, n_blobs=10, n_rects=6, seed=seed) if textures
          else jt.SyntheticShapes(image_size=SIZE, seed=seed))
    rng = np.random.RandomState(seed + 1)
    out = {"image": [], "cells": [], "H": [], "cells2": []}
    for _ in range(B):
        img, c = ds.sample()
        Hm = jt.sample_homography(rng, SIZE)
        out["image"].append(img)
        out["cells"].append(ds.corners_to_cells(c))
        out["H"].append(Hm)
        out["cells2"].append(ds.corners_to_cells(jt.warp_labels(c, Hm, SIZE)))
    out = {k: np.stack(v) for k, v in out.items()}
    out["image"] = out["image"].astype(np.float64)
    out["H"] = out["H"].astype(np.float64)
    out["image2"] = np.stack([np.flipud(im) for im in out["image"]])
    assert off_boundary(out["H"])
    return out


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def adam_keeping_grads(lr):
    """optax.adam, with the gradient it was given kept in its state."""
    inner = optax.adam(lr)

    def init(p):
        return inner.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, s, p=None):
        u, s0 = inner.update(g, s[0], p)
        return u, (s0, g)

    return optax.GradientTransformation(init, update)


def jax_nets():
    v_plain = flax_variables(JSuperPointNet(), (1, *SIZE, 1))
    v_g2 = flax_variables(JGauss2(), (1, *SIZE, 1))
    return {"plain": v_plain, "gauss2": v_g2}


NET_OF = {"detector": "plain", "detector_bn": "gauss2", "joint": "plain",
          "warped_joint": "gauss2"}


def _jax_step(name, jnet, tx):
    if name == "detector":
        return jt.make_detector_train_step(jnet, tx)
    if name == "detector_bn":
        return jt.make_detector_train_step_bn(jnet, tx)
    if name == "joint":
        return jt.make_joint_sp_train_step(jnet, tx, hard_neg=HARD_NEG["joint"])
    return jt.make_warped_joint_train_step(jnet, tx, hard_neg=HARD_NEG["warped_joint"])


def _port_step(name, net, opt):
    if name == "detector":
        return tt.make_detector_train_step(net, opt)
    if name == "detector_bn":
        return tt.make_detector_train_step_bn(net, opt)
    if name == "joint":
        return tt.make_joint_sp_train_step(net, opt, hard_neg=HARD_NEG["joint"])
    return tt.make_warped_joint_train_step(net, opt, hard_neg=HARD_NEG["warped_joint"])


def ha_inputs():
    rng = np.random.RandomState(4)
    ds = jt.SyntheticShapes(image_size=(64, 96), seed=9)
    imgs = np.stack([ds.sample()[0] for _ in range(2)]).astype(np.float64)
    Hs = np.stack([jt.sample_homography(rng, (64, 96)) for _ in range(3)]).astype(np.float64)
    return imgs, Hs


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX-side result of this module: one step of each builder (its
    loss or metrics, gradients, updated parameters and batch statistics)
    and the HA heatmap, in float64."""
    nets = jax_nets()
    batch = make_batch()
    out = {"nets": nets, "batch": batch}
    with superpoint_float64():
        for name in STEPS:
            kind = NET_OF[name]
            jnet = (JSuperPointNet if kind == "plain" else JGauss2)(dtype=jnp.float64)
            v = _f64(nets[kind])
            tx = adam_keeping_grads(LR)
            params = v["params"] if name == "detector_bn" else v
            opt_state = tx.init(params)
            step = _jax_step(name, jnet, tx)
            jb = {k: jnp.asarray(a) for k, a in batch.items()}
            new, opt_state, m = step(v, opt_state, jb)
            out[name] = {"metrics": jax.tree_util.tree_map(np.asarray, m),
                         "grads": jax.tree_util.tree_map(np.asarray, opt_state[1]),
                         "new": jax.tree_util.tree_map(np.asarray, new)}
        imgs, Hs = ha_inputs()
        jnet = JSuperPointNet(dtype=jnp.float64)
        out["ha"] = np.asarray(jt.homographic_adaptation(jnet, _f64(nets["plain"]),
                                                         jnp.asarray(imgs), jnp.asarray(Hs)))
    return out


def port_net(kind, variables):
    net = (SuperPointNet() if kind == "plain" else SuperPointNetGauss2()).eval()
    net.load_state_dict(superpoint_state_from_flax(variables), strict=True)
    return net.double()


def test_data_generators_equal_jax():
    for seed in (0, 3):
        for size in ((120, 160), (48, 64)):
            a, b = jt.SyntheticShapes(size, seed=seed), tt.SyntheticShapes(size, seed=seed)
            for _ in range(3):
                (ia, ca), (ib, cb) = a.sample(), b.sample()
                np.testing.assert_array_equal(ia, ib)
                np.testing.assert_array_equal(ca, cb)
                np.testing.assert_array_equal(a.corners_to_cells(ca), b.corners_to_cells(cb))
            ba, bb = a.batch(2), b.batch(2)
            for k in ba:
                np.testing.assert_array_equal(ba[k], bb[k])
            a = jt.CornerTextures(size, n_blobs=12, n_rects=5, seed=seed)
            b = tt.CornerTextures(size, n_blobs=12, n_rects=5, seed=seed)
            for (ia, ca), (ib, cb) in zip(a.pool(2), b.pool(2)):
                np.testing.assert_array_equal(ia, ib)
                np.testing.assert_array_equal(ca, cb)
            ra, rb = np.random.RandomState(seed), np.random.RandomState(seed)
            for _ in range(3):
                Ha, Hb = jt.sample_homography(ra, size), tt.sample_homography(rb, size)
                np.testing.assert_array_equal(Ha, Hb)
                np.testing.assert_array_equal(jt.warp_labels(ca, Ha, size),
                                              tt.warp_labels(cb, Hb, size))
            assert ra.randint(1 << 30) == rb.randint(1 << 30)
    assert len(tt.warp_labels(np.zeros((0, 2)), np.eye(3), (8, 8))) == 0


@pytest.mark.parametrize("case", ["dense", "hard_neg", "ties"])
def test_losses_and_input_gradients_match_jax(case):
    """'ties' gives one-hot descriptors, equal across the pair at some
    cells: positives at dot = 1 exactly, the hinge's kink, where both take
    jnp.maximum's gradient 1/2."""
    hard_neg = 4 if case == "hard_neg" else 0
    rng = np.random.RandomState(len(case))
    semi = rng.randn(B, 6, 8, 65)
    cells = rng.randint(0, 65, (B, 6, 8))
    if case == "ties":
        d1 = np.eye(16)[rng.randint(0, 16, (B, 6, 8))]
        d2 = np.eye(16)[rng.randint(0, 16, (B, 6, 8))]
        d2[:, 1:5, 1:7] = d1[:, 1:5, 1:7]
    else:
        d1 = rng.randn(B, 6, 8, 16)
        d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
        d2 = rng.randn(B, 6, 8, 16)
        d2[:, 2:5, 3:6] = d1[:, 2:5, 3:6] + 0.1 * d2[:, 2:5, 3:6]  # similar positives
        d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    H = make_batch(seed=5)["H"]
    H[1] = np.eye(3)
    H[1, :2, 2] = (1.0, -2.0)
    assert off_boundary(H)

    jl, jg = jax.value_and_grad(jt.detector_loss)(jnp.asarray(semi), jnp.asarray(cells))
    ts = _t(semi).requires_grad_()
    tl = tt.detector_loss(ts, _t(cells))
    tl.backward()
    _close(jl, tl)
    _close(jg, ts.grad)

    jfn = lambda a, b: jt.descriptor_loss(a, b, jnp.asarray(H), hard_neg=hard_neg)  # noqa: E731
    jl, (g1, g2) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(d1), jnp.asarray(d2))
    t1, t2 = _t(d1).requires_grad_(), _t(d2).requires_grad_()
    tl = tt.descriptor_loss(t1, t2, _t(H), hard_neg=hard_neg)
    tl.backward()
    _close(jl, tl)
    _close(g1, t1.grad)
    _close(g2, t2.grad)
    assert float(tl.detach()) > 0 and float(t1.grad.abs().max()) > 0


@pytest.mark.parametrize("name", STEPS)
def test_train_step_matches_jax(jax_runs, name):
    kind = NET_OF[name]
    v = jax_runs["nets"][kind]
    want = jax_runs[name]
    net = port_net(kind, v)
    buffers0 = {k: b.clone() for k, b in net.named_buffers()}
    opt = tt.adam(net, LR)
    step = _port_step(name, net, opt)
    m = step(jax_runs["batch"])
    if isinstance(m, dict):
        assert set(m) == set(want["metrics"]) == {"loss", "det", "desc"}
        for k in m:
            _close(want["metrics"][k], m[k])
    else:
        _close(want["metrics"], m)
    # Gradients and the updated parameters, leaf by leaf in the port's names.
    jgrads = want["grads"]
    jgrads = jgrads.get("params", jgrads)
    new = want["new"]
    for k, p in net.named_parameters():
        _leaf_close(_leaf(jgrads, k, True), p.grad, f"{name} gradient {k}")
        _leaf_close(_leaf(new.get("params", new), k, True), p, f"{name} parameter {k}",
                    floor=1.0)
    if name == "detector_bn":
        # The train-mode forward's running statistics, written back once.
        for k, b in net.named_buffers():
            if k.endswith(("running_mean", "running_var")):
                _leaf_close(_leaf(new["batch_stats"], k, False), b, f"buffer {k}")
                assert not torch.equal(b, buffers0[k]), k
        assert not net.training
    elif kind == "gauss2":
        for k, b in net.named_buffers():
            assert torch.equal(b, buffers0[k]), f"{name} moved buffer {k}"


def _jpath(k):
    """A port state-dict key -> (flax module path, leaf kind)."""
    from deepfepe_tpu_torch.utils.weights import GAUSS2_SEQ

    parts = k.split(".")
    inv = {str(i): n for n, i in GAUSS2_SEQ.items()}
    if parts[0] == "inc":
        return ["inc", inv[parts[3]]], parts[4]
    if parts[0].startswith("down"):
        return [parts[0], inv[parts[4]]], parts[5]
    return [parts[0]], parts[1]


def _leaf(tree, k, param: bool):
    path, leaf = _jpath(k)
    node = tree
    for p in path:
        node = node[p]
    if "kernel" in node:
        a = np.asarray(node["kernel" if leaf == "weight" else "bias"])
        return a.transpose(3, 2, 0, 1) if leaf == "weight" else a
    if param:
        return np.asarray(node["scale" if leaf == "weight" else "bias"])
    return np.asarray(node["mean" if leaf == "running_mean" else "var"])


def test_homographic_adaptation_and_cells_match_jax(jax_runs):
    imgs, Hs = ha_inputs()
    net = port_net("plain", jax_runs["nets"]["plain"])
    got = tt.homographic_adaptation(net, _t(imgs), _t(Hs))
    want = jax_runs["ha"]
    assert got.shape == (2, 64, 96) and float(want.max()) > 0
    _close(want, got)
    for k in range(2):
        np.testing.assert_array_equal(tt.heatmap_to_cells(want[k], 0.015),
                                      jt.heatmap_to_cells(want[k], 0.015))
        np.testing.assert_array_equal(tt.heatmap_to_cells(got[k].numpy(), 0.015),
                                      jt.heatmap_to_cells(want[k], 0.015))


def test_steps_take_the_joint_steps_conv_backend(monkeypatch):
    """A float32 net's step runs its convs under `exact_convs` (no TF32, no
    oneDNN, no cuDNN), a bf16 net's under `full_f32` (cuDNN left on), as the
    joint train step chooses; the step's loss is taken inside that block."""
    seen = []
    loss = tt.detector_loss
    monkeypatch.setattr(tt, "detector_loss", lambda *a: seen.append(
        (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
         torch.backends.mkldnn.enabled)) or loss(*a))
    torch.manual_seed(0)
    net = SuperPointNet().eval()
    step = tt.make_detector_train_step(net, tt.adam(net, LR))
    batch = make_batch()
    step({"image": batch["image"].astype(np.float32), "cells": batch["cells"]})
    assert seen == [(False, False, False)]
    with step_convs(SuperPointNet(dtype=torch.bfloat16)):
        assert torch.backends.cudnn.enabled and not torch.backends.cudnn.allow_tf32
        assert not torch.backends.mkldnn.enabled
    assert torch.backends.cudnn.enabled and torch.backends.mkldnn.enabled
