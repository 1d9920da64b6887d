"""Port parity: the bf16 SuperPoint nets (`dtype=torch.bfloat16`) against the
JAX package's flax modules and fused forwards in bf16, and `remat`.

Weights are the JAX modules' (`init`, the gauss2 running statistics
randomized with zero-centred means), carried by `superpoint_state_from_flax`;
the port's parameters and buffers stay float32.

- The module forward in eval mode, SuperPointNet and SuperPointNetGauss2:
  `semi` and `desc` within 3e-2 of their largest entry (the bf16 bar of
  tests/test_torch_deepfnet.py:61); both float32 on return.
- Train-mode BatchNorm with bn_groups = 2 (gauss2): the outputs at the same
  bar, and the running buffers the forward writes against JAX's
  write-back, each within 3e-2 of its largest entry (statistics in float32
  of bf16 activations that round in other places); num_batches_tracked up
  by 2.
- The fused forward on the plain route ('xla') against the JAX package's
  `gauss2_forward_fused(dtype=bfloat16)` and `plain_forward_fused`, and on
  the 'pallas' route (every 3x3 layer on the bf16 K5 Function) against the
  JAX fused forward with its `sp_pallas._backend` patched in the test to
  "pallas" (the JAX kernel in interpret mode): 3e-2.
- remat: under 'block' and 'full' the SuperPoint's parameter gradients (on
  fixed cotangents) are bit-equal to 'none' on the fused route in float32
  and bf16 and on the module route with train-mode BatchNorm; a rerun
  calls the K5 Function again (the encoder's 8 layers under 'block', all
  10 under 'full'); the running buffers after a
  remat train-mode pass equal those after a 'none' pass, and
  num_batches_tracked advances once a pass (by bn_groups).
"""

import copy
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.frontend import sp_pallas
from deepfepe_tpu.frontend.superpoint import SuperPointNet as JPlain
from deepfepe_tpu.frontend.superpoint import SuperPointNetGauss2 as JGauss2
from deepfepe_tpu_torch.frontend import FrontendParams, SuperPointNet, SuperPointNetGauss2
from deepfepe_tpu_torch.frontend.pipeline import run_superpoint
from deepfepe_tpu_torch.utils.weights import superpoint_state_from_flax

sp_fused = importlib.import_module("deepfepe_tpu_torch.frontend.sp_fused")
conv = importlib.import_module("deepfepe_tpu_torch.ops.conv")

BF16 = torch.bfloat16
SHAPE = (2, 32, 48, 1)
BAR = 3e-2


def _image(seed=0, shape=SHAPE):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _variables(kind, seed=2):
    jnet = (JGauss2 if kind == "gauss2" else JPlain)(dtype=jnp.bfloat16)
    v = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(1),
                                                     jnp.zeros(SHAPE, jnp.float32)))
    v = dict(v)
    if "batch_stats" in v:
        rng = np.random.RandomState(seed)
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, a: ((0.1 * rng.randn(*a.shape)) if path[-1].key == "mean"
                             else np.abs(1 + 0.3 * rng.randn(*a.shape)) + 0.05)
            .astype(np.float32), v["batch_stats"])
    return jnet, v


def _port(kind, v, dtype=BF16):
    net = (SuperPointNetGauss2 if kind == "gauss2" else SuperPointNet)(dtype=dtype)
    net.load_state_dict(superpoint_state_from_flax(v), strict=True)
    return net.eval()


def _close(got, want, bar=BAR):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(g - w).max() / np.abs(w).max())
    assert err <= bar, err
    return err


@pytest.mark.parametrize("kind", ["plain", "gauss2"])
def test_bf16_module_forward_matches_flax(kind):
    jnet, v = _variables(kind)
    x = _image()
    want = jnet.apply(v, x)
    got = _port(kind, v)(torch.from_numpy(x))
    for k in ("semi", "desc"):
        assert got[k].dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in _port(kind, v).state_dict().values()
                   if p.is_floating_point())
        _close(got[k].detach().numpy(), want[k])


def test_bf16_train_mode_batchnorm_matches_flax():
    jnet, v = _variables("gauss2")
    x = _image(1)
    want, new = jnet.apply(v, x, train=True, bn_groups=2, mutable=["batch_stats"])
    net = _port("gauss2", v).train()
    got = net(torch.from_numpy(x), bn_groups=2)
    for k in ("semi", "desc"):
        _close(got[k].detach().numpy(), want[k])
    jb = superpoint_state_from_flax({"params": v["params"], "batch_stats": new["batch_stats"]})
    for k, b in net.named_buffers():
        if k.endswith("num_batches_tracked"):
            assert int(b) == 2
        else:
            _close(b.numpy(), jb[k].numpy())


@pytest.mark.parametrize("kind", ["plain", "gauss2"])
def test_bf16_fused_forward_matches_jax_on_the_plain_route(kind):
    jnet, v = _variables(kind)
    x = _image(2)
    want = sp_pallas.superpoint_forward_fused(jnet, v, jnp.asarray(x))
    got = sp_fused.superpoint_forward_fused(_port(kind, v), torch.from_numpy(x), "xla")
    for k in ("semi", "desc"):
        assert got[k].dtype == torch.float32
        _close(got[k].detach().numpy(), want[k])


def test_bf16_fused_forward_matches_jax_on_the_kernel_route(monkeypatch):
    jnet, v = _variables("gauss2")
    x = _image(3)
    monkeypatch.setattr(sp_pallas, "_backend", lambda x: "pallas")
    want = sp_pallas.superpoint_forward_fused(jnet, v, jnp.asarray(x))
    monkeypatch.setattr(sp_fused, "MIN_PX_PALLAS", 0)
    with conv.record_calls() as calls:
        got = sp_fused.superpoint_forward_fused(_port("gauss2", v), torch.from_numpy(x),
                                                "pallas")
    assert len(calls) == 10 and all(c["x"].dtype == BF16 for c in calls)
    for k in ("semi", "desc"):
        _close(got[k].detach().numpy(), want[k])


def _grads(net, out, cot):
    net.zero_grad()
    sum((out[k] * cot[k]).sum() for k in cot).backward()
    return {k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_remat_gradients_are_bit_equal_on_the_fused_route(monkeypatch, dtype):
    _, v = _variables("gauss2")
    net = _port("gauss2", v, dtype)
    x = torch.from_numpy(_image(4))
    monkeypatch.setattr(sp_fused, "MIN_PX_PALLAS", 0)
    rng = np.random.RandomState(5)
    cot = {"semi": torch.from_numpy(rng.randn(2, 4, 6, 65).astype(np.float32)),
           "desc": torch.from_numpy(rng.randn(2, 4, 6, 256).astype(np.float32))}
    grads, n_calls = {}, {}
    for remat in ("none", "block", "full"):
        with conv.record_calls() as calls:
            grads[remat] = _grads(net, sp_fused.superpoint_forward_fused(net, x, "pallas", remat),
                                  cot)
        n_calls[remat] = len(calls)
    assert n_calls == {"none": 10, "block": 18, "full": 20}  # the heads are in no block
    assert len(grads["none"]) == len(list(net.parameters()))
    for remat in ("block", "full"):
        assert all(torch.equal(grads["none"][k], g) for k, g in grads[remat].items()), remat
        assert grads[remat].keys() == grads["none"].keys()


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_remat_on_the_module_route_with_train_mode_batchnorm(dtype):
    _, v = _variables("gauss2")
    base = _port("gauss2", v, dtype)
    imgs = torch.from_numpy(_image(6, (4, 32, 48)))
    out = {}
    for remat in ("none", "block", "full"):
        net = copy.deepcopy(base)
        fp = FrontendParams(out_num_points=32, conf_thresh=1e-4, conv_backend="flax",
                            remat=remat)
        k = run_superpoint(net, imgs, fp, bn_train=True, bn_groups=2)
        net.zero_grad()
        (k.desc.sum() + (k.offsets * k.scores[..., None]).sum()).backward()
        out[remat] = ({n: p.grad.clone() for n, p in net.named_parameters()
                       if p.grad is not None}, dict(net.named_buffers()))
        assert not net.training
    g0, b0 = out["none"]
    assert len(g0) > 40
    for remat in ("block", "full"):
        g, b = out[remat]
        assert g.keys() == g0.keys() and all(torch.equal(g0[n], g[n]) for n in g0), remat
        assert all(torch.equal(b0[n], b[n]) for n in b0), remat
        assert int(b["inc.conv.conv.1.num_batches_tracked"]) == 2
    moved = [n for n, t in b0.items() if n.endswith("running_mean")
             and not torch.equal(t, dict(base.named_buffers())[n])]
    assert len(moved) == 12  # every BatchNorm took the forward's update
