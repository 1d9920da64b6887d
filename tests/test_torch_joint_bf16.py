"""Port parity: one joint SuperPoint + DeepF step with a bf16 SuperPoint
(SuperPointNetGauss2(dtype=bfloat16), the JAX CLI's frontend when
`model.mlp_dtype` is bfloat16) against the JAX package's
`make_joint_train_step` with the same net, at tests/test_joint.py's size
(tests/_torch_joint_setup.py's nets, weights and batch).

bf16 rounds at other places in the two packages, so the whole step is not
held to a float64 bar (README, the bf16 train-step gotcha). Instead:

- bn_mode 'frozen' (the fused forward, every 3x3 layer on the bf16 K5
  Function, the pixel threshold at 0): every K5/K5b call of the port's
  step (`ops.conv.record_calls`, 10 a step) goes through the JAX kernel
  and its VJP (`conv3x3_affine_relu(backend="pallas")`, interpret mode) on
  the same inputs and the same cotangent: y within one bf16 ulp plus 1e-5;
  dx and dw (bf16) within one ulp plus 1e-4 of their largest entry; dscale
  and dbias within 1e-4 of their largest entry plus 1e-6 (float32 sums of
  terms of both signs, in other orders: 1.9e-7 seen on a dscale of 7e-4). The wiring exactly: each
  3x3 conv weight's gradient is the bf16 dw of its one call, cast up.
- bn_mode 'train' (the module forward in bf16 with train-mode BatchNorm):
  the running buffers the step writes back against JAX's, each within
  3e-2 of its largest entry (tests/test_torch_superpoint_bf16.py's bar).
- Both modes: where the two packages' ordered match lists agree, the
  match counts equal and the loss within 2e-2 of JAX's (the bf16 MLP's
  step bar, tests/test_torch_train.py). At this size they agree at none of
  the batch seeds 3-10 in either mode (measured: bf16 scores of the
  untrained net tie, and the two packages order the keypoints apart; the
  counts a pair differ by 0-3), so at the test's seed the loss is not
  compared and the step is held by its calls and its write-back. Both
  steps finite, with no skipped update.
"""

import copy
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_joint_setup import (DEPTH, FP, SIZE, JFrontendParams, JGauss2, batch, jax_cfg,
                                jax_variables, jget_matches, keep_grads, match_order, port_cfg,
                                port_nets)
from deepfepe_tpu.frontend import sp_pallas
from deepfepe_tpu.models import DeepFNet as JDeepFNet
from deepfepe_tpu.ops.pallas.conv_pallas import conv3x3_affine_relu as jconv
from deepfepe_tpu.train.joint import JointTrainState, make_joint_train_step
from deepfepe_tpu_torch.frontend import FrontendParams, SuperPointNetGauss2, get_matches_from_sp
from deepfepe_tpu_torch.train.joint import joint_train_step, make_joint_state
from deepfepe_tpu_torch.utils.weights import superpoint_state_from_flax
from _torch_threads import one_torch_thread  # noqa: F401

conv = importlib.import_module("deepfepe_tpu_torch.ops.conv")
sp_fused = importlib.import_module("deepfepe_tpu_torch.frontend.sp_fused")

BF16 = torch.bfloat16
ULP, FLOOR, REL, BUF_BAR, LOSS_BAR = 2.0 ** -7, 1e-5, 1e-4, 3e-2, 2e-2
SUM_FLOOR = 1e-6  # float32 sums of terms of both signs: 1.9e-7 seen where the sum is 7e-4


def _nets():
    sp, deepf = port_nets("gauss2")
    bf = SuperPointNetGauss2(dtype=BF16)
    bf.load_state_dict(sp.state_dict(), strict=True)
    return bf.eval(), deepf


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32),
                      np.float64)


def _hold_call(c):
    """One recorded K5/K5b call against the JAX kernel and its VJP."""
    args = [jnp.asarray(c[k].float().numpy()).astype(jnp.bfloat16) for k in ("x", "w")]
    args += [jnp.asarray(c[k].numpy()) for k in ("scale", "bias")]
    y, vjp = jax.vjp(lambda *a: jconv(*a, need_dx=c["need_dx"], backend="pallas"), *args)
    a, b = _np(c["y"]), _np(y)
    assert np.all(np.abs(a - b) <= ULP * np.abs(b) + FLOOR)
    jg = vjp(jnp.asarray(c["dy"].float().numpy()).astype(jnp.bfloat16))
    for k, ref in zip(("dx", "dw"), jg[:2]):
        g, r = _np(c[k]), _np(ref)
        assert np.all(np.abs(g - r) <= ULP * np.abs(r) + REL * np.abs(r).max()), k
    for k, ref in zip(("dscale", "dbias"), jg[2:]):
        g, r = _np(c[k]), _np(ref)
        assert np.abs(g - r).max() <= REL * np.abs(r).max() + SUM_FLOOR, k


def _jax_step(sp_state_dict, deepf, tb_np, bn_mode, monkeypatch):
    """The JAX step: 'frozen' through its fused forward with every 3x3 layer
    on its kernel (`sp_pallas._backend` patched to "pallas", as the port's
    pixel threshold is set to 0), 'train' through its module forward."""
    jsp = JGauss2(dtype=jnp.bfloat16)
    monkeypatch.setattr(sp_pallas, "_backend", lambda x: "pallas")
    sp32 = SuperPointNetGauss2()
    sp32.load_state_dict(sp_state_dict)
    jsp_vars, jdeepf_vars = jax_variables(sp32, deepf)
    jb = {k: jnp.asarray(v) for k, v in tb_np.items()}
    jfp = JFrontendParams(**FP, conv_backend="fused" if bn_mode == "frozen" else "flax")
    jm = jax.jit(lambda v, a, c: jget_matches(jsp, v, (a, c), jfp,
                                              bn_train=bn_mode == "train"))(
        jsp_vars, jb["imgs_grey"][:, 0], jb["imgs_grey"][:, 1])["matches"]
    jdeepf = JDeepFNet(depth=DEPTH, image_size=SIZE, if_quality=True, sign_canonical=True,
                       mlp_dtype=jnp.float32)
    tx = keep_grads()
    step = make_joint_train_step(jdeepf, jsp, jfp, tx, tx, jax_cfg(), bn_mode=bn_mode)
    jstate, jmetrics = jax.device_get(step(
        JointTrainState.create(jdeepf_vars, jsp_vars, tx, tx), jb, 0.1, 0.5))
    return match_order(jm), jstate, {k: float(v) for k, v in jmetrics.items() if np.ndim(v) == 0}


@pytest.mark.parametrize("bn_mode", ["frozen", "train"])
def test_bf16_joint_step_matches_jax(monkeypatch, bn_mode):
    sp, deepf = _nets()
    sd0 = copy.deepcopy(sp.state_dict())
    b = batch(3)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    fp = FrontendParams(**FP, conv_backend="fused", conv_impl="pallas")
    monkeypatch.setattr(sp_fused, "MIN_PX_PALLAS", 0)
    frames = (tb["imgs_grey"][:, 0], tb["imgs_grey"][:, 1])
    with torch.no_grad():
        port_m = get_matches_from_sp(copy.deepcopy(sp), frames, fp,
                                     bn_train=bn_mode == "train")["matches"]
    jorder, jstate, jm = _jax_step(sd0, deepf, b, bn_mode, monkeypatch)
    cfg = port_cfg()
    deepf_copy = copy.deepcopy(deepf)
    with conv.record_calls() as calls:
        m = joint_train_step(make_joint_state(deepf_copy, sp, cfg), tb, fp, cfg, 0.1, 0.5,
                             bn_mode=bn_mode)
    assert float(m["skipped_update"]) == jm["skipped_update"] == 0.0
    assert np.isfinite(float(m["g_sp_norm"])) and float(m["g_sp_norm"]) > 0
    if match_order(port_m) == jorder:
        assert float(m["num_matches"]) == jm["num_matches"]
        assert abs(float(m["loss"]) - jm["loss"]) <= LOSS_BAR * abs(jm["loss"])
    if bn_mode == "frozen":
        assert len(calls) == 10 and all(c["x"].dtype == BF16 and "dy" in c for c in calls)
        for c in calls:
            _hold_call(c)
        convs = [mod for mod in sp.modules()
                 if isinstance(mod, torch.nn.Conv2d) and mod.kernel_size == (3, 3)]
        assert len(convs) == 10
        for mod in convs:
            w = mod.weight.detach()
            # The step's update moved the weight: find its call by its input weight.
            mine = [c for c in calls if torch.equal(
                c["w"], sd0_weight(sd0, sp, mod).permute(2, 3, 1, 0).to(BF16))]
            assert len(mine) == 1 and w.shape == mod.weight.grad.shape
            assert torch.equal(mod.weight.grad, mine[0]["dw"].float().permute(3, 2, 0, 1))
    else:
        assert not calls  # train-mode BatchNorm takes the module forward
        want = superpoint_state_from_flax(jstate.sp_params)
        for k, buf in sp.named_buffers():
            if k.endswith("num_batches_tracked"):
                assert int(buf) == 2
                continue
            r = want[k].numpy()
            assert not torch.equal(buf, sd0[k]), k
            assert np.abs(buf.numpy() - r).max() <= BUF_BAR * np.abs(r).max(), k


def sd0_weight(sd0, sp, mod):
    """The weight `mod` had before the step, from the saved state dict."""
    name = next(n for n, m in sp.named_modules() if m is mod)
    return sd0[f"{name}.weight"]
