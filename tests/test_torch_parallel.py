"""Port parity: the parallel layer (`deepfepe_tpu_torch/parallel/`), the
data-parallel train step, sync BatchNorm and the dry-run tool.

One world of four CPU ranks under gloo (`tests/_torch_dist.py`, suite
'parallel') runs every case; this process holds the results against the
JAX package and the port on one process, on the same numpy-seeded
weights and batches (SyntheticPairs, N = 128, B = 4, unfused MLPs,
sign-canonical null vectors):

- the data-parallel step on the (4, 1) mesh, one pair a rank, against the
  JAX single-device loss and gradient (`compute_losses` under
  `value_and_grad`) in F and qt mode, both packages in float64: loss rtol
  1e-5, gradient cosine above 1 - 1e-5 (tests/test_model_train.py's bars
  for the 8-vs-1 mesh). In float32 the packages' gradients at these
  untrained weights differ by more than that (cosine 0.99993 measured:
  the per-leaf bars of tests/test_torch_train.py, not these), so float32
  is held within the port below;
- with the sample loss, against the port's one-process step with the same
  generator (the draws are the global batch's on every rank): the same
  bars;
- DP x TP on the (2, 2) mesh against the replicated (data-parallel) step
  and the JAX loss, float64: loss rtol 1e-5 (tests/test_tp.py:82),
  gradient cosine 1 - 1e-5, the 1024/512/256-wide leaves sliced in half
  and gathered whole again, a second step lowering the loss, the
  Trainer's checkpoint of the sharded net gathered whole (weights and
  Adam moments) and loaded strictly into a whole net;
- the N-sharded fit over a model group of four against JAX
  `make_nsharded_fit` on four of conftest's eight CPU devices: F (unit,
  sign-aligned) and the residual to 2e-5, the gradient of sum |F| to atol
  5e-4 / rtol 1e-3 (tests/test_tp.py:151,168); with the residual in the
  loss too, against the port's one-device fit at the same bars;
- train-mode gauss2 BatchNorm synchronized over four ranks against the
  single process on the global batch, float64: outputs, running buffers
  (on every rank) and summed gradients to 1e-9 relative (a leaf that
  vanishes in exact arithmetic, to 1e-9 of the largest);
- `tools/dryrun_multichip.dryrun` in the same world at 64x96 frames: its
  summary line.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfepe_tpu.models.deepfnet import DeepFNet as JDeepFNet
from deepfepe_tpu.parallel import make_mesh as jmake_mesh
from deepfepe_tpu.parallel import make_nsharded_fit as jmake_nsharded_fit
from deepfepe_tpu.train.config import config_from_dict as jconfig_from_dict
from deepfepe_tpu.train.engine import compute_losses as jcompute_losses
from deepfepe_tpu.utils.torch_import import convert_deepf_state
from deepfepe_tpu_torch.frontend import SuperPointNetGauss2
from deepfepe_tpu_torch.frontend.superpoint import reset_superpoint
from deepfepe_tpu_torch.ops.fmatrix import weighted_eight_point
from deepfepe_tpu_torch.train import Trainer, train_step
from deepfepe_tpu_torch.utils.device import batch_to_device
from deepfepe_tpu_torch.utils.weights import deepfnet_state_from_flax, to_reference_layout
from _torch_dist import (World, as64, nshard_inputs, solver_batch, solver_cfg, solver_cfg_dict,
                         solver_net, sp_inputs)
from _torch_threads import one_torch_thread  # noqa: F401

WORLD = 4


@pytest.fixture(scope="module")
def world():
    return World("parallel", WORLD)


@pytest.fixture(scope="module")
def results(world):
    return world.result()


def _cos(a: dict, b: dict) -> float:
    va = np.concatenate([np.ravel(a[k]) for k in sorted(b)])
    vb = np.concatenate([np.ravel(b[k]) for k in sorted(b)])
    return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))


def _jax_loss_grads(mode: str, depth: int = 3):
    """The JAX single-device loss and gradient (port layout) at the port's
    seeded weights on the whole batch, in float64."""
    net = solver_net(solver_cfg(mode, depth), dtype=torch.float64)
    params = convert_deepf_state(to_reference_layout(net.state_dict()))
    jnet = JDeepFNet(depth=depth, image_size=net.image_size, if_quality=True, sign_canonical=True,
                     mlp_dtype=jnp.float64)
    jcfg = jconfig_from_dict(solver_cfg_dict(mode, depth))
    jb = {k: jnp.asarray(v) for k, v in as64(solver_batch()).items()}
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: jcompute_losses(jnet, p, jb, jcfg, 0.1, 0.5)[0]))(params)
    grads = {k: v.numpy() for k, v in deepfnet_state_from_flax(jax.device_get(g)).items()}
    return float(loss), grads


@pytest.fixture(scope="module")
def jax_f(world):
    return _jax_loss_grads("F")


@pytest.mark.parametrize("mode", ["F", "qt"])
def test_dp_step_matches_jax_single_device(world, jax_f, jax_nshard, results, mode):
    jloss, jgrads = jax_f if mode == "F" else _jax_loss_grads("qt")
    r = results[0][f"dp_{mode}64"]
    np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)
    assert _cos(r["grads"], jgrads) > 1 - 1e-5
    for other in results[1:]:  # every replica holds the same averaged gradient
        for k, g in other[f"dp_{mode}64"]["grads"].items():
            np.testing.assert_array_equal(g, r["grads"][k])


def test_dp_sample_loss_matches_one_process(results):
    cfg = solver_cfg("F", depth=2, sample=True)
    net = solver_net(cfg)
    trainer = Trainer(net, cfg)
    m = train_step(net, trainer.opt, batch_to_device(solver_batch(), torch.device("cpu")), cfg,
                   0.1, 0.5, trainer.sample_generator)
    grads = {k: p.grad.numpy() for k, p in net.named_parameters()}
    r = results[0]["dp_sample"]
    np.testing.assert_allclose(r["loss"], float(m["loss"]), rtol=1e-5)
    assert _cos(r["grads"], grads) > 1 - 1e-5


def test_tp_matches_replicated(results, jax_f):
    tp, dp = results[0]["tp"], results[0]["dp_F64"]
    np.testing.assert_allclose(tp["losses"][0], dp["loss"], rtol=1e-5)
    np.testing.assert_allclose(tp["losses"][0], jax_f[0], rtol=1e-5)
    assert _cos(tp["grads"], dp["grads"]) > 1 - 1e-5
    assert tp["losses"][1] < tp["losses"][0]


def test_tp_shards_wide_layers_only(results):
    tp = results[0]["tp"]
    sharded = {k for k, s in tp["local_shapes"].items() if s != tp["full_shapes"][k]}
    # The 1024-, 512- and 256-wide Linear and InstanceNorm leaves of both
    # weight nets; the 64/128-wide stem and the 1-wide head stay whole.
    want = {f"{n}.fw.{i}.{p}" for n in ("input_weights", "update_weights")
            for i in (6, 7, 9, 10, 12, 13) for p in ("weight", "bias")}
    assert sharded == want
    for k in sharded:
        full, local = tp["full_shapes"][k], tp["local_shapes"][k]
        assert full[0] >= 256 and local[0] * 2 == full[0] and local[1:] == full[1:]
    assert tp["checkpoint_loads_whole"]


def _unit(F):
    F = F / np.linalg.norm(F, axis=(-2, -1), keepdims=True)
    return F


@pytest.fixture(scope="module")
def jax_nshard(world):
    p1, p2, w = (jnp.asarray(x) for x in nshard_inputs())
    mesh = jmake_mesh(n_data=1, n_model=WORLD, devices=jax.devices()[:WORLD])
    fit = jmake_nsharded_fit(mesh)
    F, res = jax.jit(fit)(p1, p2, w)
    g = jax.grad(lambda w_: jnp.sum(jnp.abs(fit(p1, p2, w_)[0])))(w)
    return np.asarray(F), np.asarray(res), np.asarray(g)


def test_nsharded_fit_matches_jax(results, jax_nshard):
    jF, jres, _ = jax_nshard
    F = results[0]["nshard"]["F"]
    res = np.concatenate([r["nshard"]["residual"] for r in results], axis=-1)
    a, b = _unit(F), _unit(jF)
    sign = np.sign(np.sum(a * b, axis=(-2, -1)))
    np.testing.assert_allclose(a * sign[:, None, None], b, atol=2e-5)
    np.testing.assert_allclose(res * sign[:, None], jres, atol=2e-5)
    for r in results[1:]:
        np.testing.assert_array_equal(r["nshard"]["F"], F)


def test_nsharded_fit_gradients(results, jax_nshard):
    g = np.concatenate([r["nshard"]["grad_F"] for r in results], axis=-1)
    np.testing.assert_allclose(g, jax_nshard[2], atol=5e-4, rtol=1e-3)
    # A loss on the sharded residual too: each rank's term reaches every
    # rank's weights through the all-reduced Gram.
    p1, p2, w = (torch.as_tensor(x) for x in nshard_inputs())
    w = w.clone().requires_grad_(True)
    fit = weighted_eight_point(p1, p2, w)
    (fit.F.abs().sum() + (fit.residual ** 2).sum()).backward()
    g = np.concatenate([r["nshard"]["grad_FR"] for r in results], axis=-1)
    np.testing.assert_allclose(g, w.grad.numpy(), atol=5e-4, rtol=1e-3)


def test_sync_batch_norm_matches_global_batch(results):
    frames, c_semi, c_desc = sp_inputs()
    net = reset_superpoint(SuperPointNetGauss2(), torch.Generator().manual_seed(0)).double()
    net.train()
    x = torch.as_tensor(frames).reshape(-1, *frames.shape[2:])[..., None]
    o = net(x, bn_groups=2)
    ((o["semi"] * torch.as_tensor(c_semi).flatten(0, 1)).sum()
     + (o["desc"] * torch.as_tensor(c_desc).flatten(0, 1)).sum()).backward()
    semi = o["semi"].detach().unflatten(0, (2, -1)).transpose(0, 1).numpy()
    r0 = results[0]["sync_bn"]
    np.testing.assert_allclose(r0["semi"], semi, rtol=1e-9, atol=1e-12)
    buffers = dict(net.named_buffers())
    for r in results:
        for k, v in r["sync_bn"]["buffers"].items():
            np.testing.assert_allclose(v, buffers[k].numpy(), rtol=1e-9, atol=1e-12)
    top = max(float(p.grad.abs().max()) for p in net.parameters())
    for k, p in net.named_parameters():
        g = p.grad.numpy()
        # Leaves that vanish in exact arithmetic (biases ahead of a
        # train-mode BatchNorm) are held to the net's largest gradient.
        np.testing.assert_allclose(r0["grads"][k], g, rtol=1e-9, atol=1e-9 * top)


def test_dryrun_summary(results):
    line = results[0]["dryrun"]
    m = re.match(r"dryrun_multichip\(4\): mesh=\(2x2\) flagship\(depth=5,N=1000,sample_loss,qt\) "
                 r"loss=(\S+) nshard\[N=1000 ok\] joint_sp loss=(\S+) sqrt_ba ok \(cost (\S+)->"
                 r"(\S+), 4-shard TSQR\) pose_graph ok \(mean r\^2 (\S+)->(\S+), edge-sharded "
                 r"two-stage\) ok$", line)
    assert m, line
    loss, jloss, c0, c1, r0, r1 = map(float, m.groups())
    assert math.isfinite(loss) and math.isfinite(jloss)
    assert c1 < 0.1 * c0 and r1 < r0
