"""Port parity: joint SuperPoint + DeepF training with the gauss2 frontend,
train-mode BatchNorm and the frontend's gradient paths.

- Train-mode BatchNorm with bn_groups=2 against the JAX package's
  `TorchBatchNorm` (net.apply(train=True, mutable=['batch_stats'])): each
  output within 5e-5 of its largest entry (float32 batch statistics summed
  in another order and amplified through ten normalizations of small
  batches; measured 1.4e-5, each package 1e-5 from a float64 run of the
  port), the new running buffers within 1e-6, and two batch counts a step.
- The frontend's gradient paths against jax.grad: the soft-argmax offsets
  (to the heatmap), the two-hot descriptor sampling (to the descriptor map
  and the keypoint positions) and the match scores that the K4 route
  recomputes from its indices (to both descriptor sets), each within 1e-5
  of the largest entry (float32 contractions in another order).
- One joint step against the JAX package's (tests/test_joint.py's size:
  64x96, B = 2, N = 64, depth 2) for SuperPointNetGauss2 in both bn_modes,
  the 'frozen' one through the fused forward with every 3x3 layer on the
  K5 Function (so K5b's plain version makes the SuperPoint gradients):
  equal match lists in float32 and in float64, then, in float64, the loss
  within 1e-4 (relative), the gradient norms within 1e-3 (relative) and
  every gradient leaf within 1e-3 of the JAX leaf's largest entry
  (tests/_torch_joint_setup.py; measured under 2e-6); the buffers
  bit-equal under 'frozen' and within 1e-6 of JAX's write-back under
  'train'. The update guard sits at the floor (the fewest matches in a
  pair) and lets both steps through.
- Port-only: the guard restores the buffers it skips; `train` and
  `train_SP` gate the two updates while both gradients are still made;
  the eval step leaves the buffers alone.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_joint_setup import (FP, assert_step_matches, batch, jax_variables, port_cfg,
                                port_nets, run_variant)
from deepfepe_tpu.frontend import mutual_nn_match as jmatch
from deepfepe_tpu.frontend import sample_descriptors as jsample
from deepfepe_tpu.frontend import soft_argmax_refine as jsoftargmax
from deepfepe_tpu.frontend import topk_keypoints as jtopk
from deepfepe_tpu.frontend.superpoint import SuperPointNetGauss2 as JGauss2
from deepfepe_tpu_torch.frontend import (FrontendParams, mutual_nn_match, nms_heatmap,
                                         sample_descriptors, soft_argmax_refine, topk_keypoints)
from deepfepe_tpu_torch.train.joint import joint_eval_step, joint_train_step, make_joint_state
from deepfepe_tpu_torch.utils.weights import superpoint_state_from_flax
from _torch_threads import one_torch_thread  # noqa: F401


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / (np.abs(np.asarray(b)).max()
                                                                  + 1e-12))


def test_train_mode_batchnorm_matches_jax():
    sp, deepf = port_nets("gauss2")
    jv, _ = jax_variables(sp, deepf)
    x = np.random.RandomState(0).rand(4, 32, 48, 1).astype(np.float32)
    want, new_vars = JGauss2().apply(jv, jnp.asarray(x), train=True, bn_groups=2,
                                     mutable=["batch_stats"])
    before = {k: v.clone() for k, v in sp.named_buffers()}
    sp.train()
    got = sp(torch.from_numpy(x), bn_groups=2)
    sp.eval()
    for k in ("semi", "desc"):
        assert _rel(got[k].detach().numpy(), want[k]) < 5e-5, (k, _rel(got[k].detach().numpy(),
                                                                          want[k]))
    new = superpoint_state_from_flax({"params": jv["params"], "batch_stats": new_vars[
        "batch_stats"]})
    for k, v in sp.named_buffers():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(before[k]) + 2, k
        else:
            assert not torch.equal(v, before[k]), k
            np.testing.assert_allclose(v.numpy(), new[k].numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    with pytest.raises(ValueError, match="groups"):
        sp.train()(torch.zeros(3, 16, 16, 1), bn_groups=2)


def test_frontend_gradient_paths_match_jax():
    rng = np.random.RandomState(2)
    hm = rng.rand(2, 40, 48).astype(np.float32)
    th = torch.from_numpy(hm).requires_grad_(True)
    k = soft_argmax_refine(th, topk_keypoints(nms_heatmap(th.detach(), 4), 30, 0.5), 5)
    jk = jtopk(jnp.asarray(np.asarray(nms_heatmap(torch.from_numpy(hm), 4))), 30, 0.5)
    c_off = rng.randn(2, 30, 2).astype(np.float32)
    (k.offsets * torch.from_numpy(c_off)).sum().backward()
    want = jax.grad(lambda h: jnp.sum(jsoftargmax(h, jk, patch_size=5).offsets * c_off))(
        jnp.asarray(hm))
    assert _rel(th.grad.numpy(), want) < 1e-5 and float(th.grad.abs().max()) > 0

    dm = rng.randn(2, 5, 6, 16).astype(np.float32)
    xy = (k.xy + k.offsets).detach().numpy()
    c_d = rng.randn(2, 30, 16).astype(np.float32)
    tdm, txy = torch.from_numpy(dm).requires_grad_(True), torch.from_numpy(xy).requires_grad_(True)
    (sample_descriptors(tdm, txy) * torch.from_numpy(c_d)).sum().backward()
    wdm, wxy = jax.grad(lambda d, p: jnp.sum(jsample(d, p) * c_d), (0, 1))(jnp.asarray(dm),
                                                                         jnp.asarray(xy))
    assert _rel(tdm.grad.numpy(), wdm) < 1e-5 and _rel(txy.grad.numpy(), wxy) < 1e-5

    d1 = rng.randn(2, 40, 16).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 = d1[:, ::-1] + 0.2 * rng.randn(2, 40, 16).astype(np.float32)
    d2 = (d2 / np.linalg.norm(d2, axis=-1, keepdims=True)).astype(np.float32)
    v1, v2 = rng.rand(2, 40) < 0.9, rng.rand(2, 40) < 0.9
    c_s = rng.randn(2, 40).astype(np.float32)
    wg = jax.grad(lambda a, b: jnp.sum(jmatch(a, b, v1, v2, nn_thresh=1.0).scores * c_s),
                  (0, 1))(jnp.asarray(d1), jnp.asarray(d2))
    for backend in ("xla", "pallas"):  # 'pallas' is K4's route: distances from its indices
        t1, t2 = (torch.from_numpy(a.copy()).requires_grad_(True) for a in (d1, d2))
        m = mutual_nn_match(t1, t2, torch.from_numpy(v1), torch.from_numpy(v2), 1.0,
                            backend=backend)
        (m.scores * torch.from_numpy(c_s)).sum().backward()
        assert int(m.valid.sum()) > 20
        assert _rel(t1.grad.numpy(), wg[0]) < 1e-5 and _rel(t2.grad.numpy(), wg[1]) < 1e-5


@pytest.mark.parametrize("bn_mode", ["frozen", "train"])
def test_gauss2_joint_step_matches_jax(bn_mode):
    r = run_variant("gauss2", bn_mode, fused=bn_mode == "frozen")
    assert_step_matches(r)
    assert r["metrics"]["skipped_update"] == 0.0
    moved = [k for k, v in r["buffers_after"].items() if not torch.equal(v, r["buffers_before"][k])]
    if bn_mode == "frozen":
        assert moved == []
    else:
        assert len(moved) == len(r["buffers_after"])
        for k, v in r["buffers_after"].items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(v.numpy(), r["jax_buffers_after"][k].numpy(),
                                           rtol=1e-6, atol=1e-6, err_msg=k)


def _step(kind, bn_mode="train", min_matches=0.0, **flags):
    sp, deepf = port_nets(kind)
    b = {k: torch.from_numpy(v) for k, v in batch().items()}
    before = {k: v.detach().clone() for k, v in [*sp.named_parameters(), *sp.named_buffers()]}
    before_deepf = copy.deepcopy(deepf.state_dict())
    cfg = port_cfg(min_matches)
    m = joint_train_step(make_joint_state(deepf, sp, cfg), b, FrontendParams(**FP), cfg, 0.1,
                         0.5, bn_mode=bn_mode, **flags)
    after = dict([*sp.named_parameters(), *sp.named_buffers()])
    sp_moved = {k for k, v in after.items() if not torch.equal(v, before[k])}
    deepf_moved = {k for k, v in deepf.state_dict().items() if not torch.equal(v, before_deepf[k])}
    return m, sp_moved, deepf_moved


def test_guard_restores_the_batchnorm_buffers():
    m, sp_moved, deepf_moved = _step("gauss2", min_matches=1e9)
    assert float(m["skipped_update"]) == 1.0 and float(m["g_sp_norm"]) > 0
    assert sp_moved == set() and deepf_moved == set()
    m, sp_moved, deepf_moved = _step("gauss2")
    assert float(m["skipped_update"]) == 0.0
    assert any("running_var" in k for k in sp_moved) and any("weight" in k for k in sp_moved)
    assert deepf_moved


def test_train_flags_gate_the_updates():
    m, sp_moved, deepf_moved = _step("gauss2", train_sp=False)
    assert float(m["g_sp_norm"]) > 0 and sp_moved == set() and deepf_moved
    m, sp_moved, deepf_moved = _step("gauss2", train_deepf=False)
    assert float(m["g_deepf_norm"]) > 0 and deepf_moved == set()
    assert any("weight" in k for k in sp_moved)
    with pytest.raises(ValueError, match="bn_mode"):
        _step("plain", bn_mode="eval")


def test_joint_eval_step_runs_the_frontend_in_eval_mode():
    sp, deepf = port_nets("gauss2")
    before = {k: v.clone() for k, v in sp.named_buffers()}
    b = {k: torch.from_numpy(v) for k, v in batch().items()}
    m = joint_eval_step(deepf, sp, b, FrontendParams(**FP), port_cfg())
    assert all(torch.equal(v, before[k]) for k, v in sp.named_buffers())
    assert torch.isfinite(m["loss"]) and m["matches_xy"].shape == (2, FP["out_num_points"], 4)
    assert 10 < float(m["num_matches"]) <= FP["out_num_points"]
