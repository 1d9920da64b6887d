"""Port parity: one Adam train step against the JAX package's
`make_train_step`, and the step's guards.

Both packages start from the JAX parameters (carried by
`deepfnet_state_from_flax`) and take the same numpy batch (SyntheticPairs,
N = 64, B = 2, depth 2, sign-canonical null vectors). Compared: the loss,
every parameter's gradient, the parameters after one Adam step, and the
`nonfinite` and `skipped` flags.

- float32, unfused MLP (the algorithm): loss to 1e-4 relative and each
  gradient to 2e-3 of its largest entry (measured: loss 2e-7, gradients
  below 2e-5). The packages sum in other orders and solve the 9x9 and 3x3
  eigenproblems with other float32 code. Gradients that are zero in exact
  arithmetic (hidden biases under InstanceNorm, the final bias under the
  softmax) are rounding crumbs of 1e-11 to 2e-8 in both and are held
  below 1e-6. After one Adam step every update is lr * g / (|g| + 1e-8):
  where |g| > 1e-6 the updates agree to 1e-2 lr; a crumb's update has
  either sign, so there only Adam's bound (two lr apart) holds.
- bfloat16 with `use_pallas_mlp` (the JAX kernel in interpret mode, the
  port's plain versions): the loss to 2e-2 (measured 9e-5). The whole
  step's bf16 gradient is mostly rounding at this size, in both packages
  (the JAX package's own fused and unfused routes differ by 140-190% on
  input_weights), so the MLP is held call by call: every fused call of
  the port's step (recorded by `ops.mlp.record_calls`) goes through JAX
  `fused_pointnet_mlp` and its VJP on the same inputs and cotangent. The
  logits to 3e-2 of the largest (test_torch_mlp.py's bar for the JAX
  kernel); the x-gradient and each parameter's gradient summed over its
  calls to 0.3 in the Frobenius norm, relative (measured at most 0.155;
  a zero gradient is 1 away, a negated one 2). The wiring is held
  exactly: each parameter's step gradient is the sum of the plain
  backward's outputs over its calls, and the x-gradient that reached each
  call's input is the plain backward's. The final bias, whose exact
  gradient vanishes under the softmax, is held to the rounding of g's
  bf16 cast; the hidden biases get exactly zero.
- `chip_smoke.fused_step_report`, the card's check of the same step,
  passes on this step and fails with each wiring fault that
  `chip_smoke.plant` can plant.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.data.synthetic import SyntheticPairs
from deepfepe_tpu.models.deepfnet import DeepFNet as JDeepFNet
from deepfepe_tpu.ops.pallas.mlp_pallas import fused_pointnet_mlp as jfused
from deepfepe_tpu.train.config import config_from_dict as jconfig_from_dict
from deepfepe_tpu.train.engine import TrainState
from deepfepe_tpu.train.engine import make_optimizer as jmake_optimizer
from deepfepe_tpu.train.engine import make_train_step
from deepfepe_tpu_torch.models import DeepFNet
from deepfepe_tpu_torch.ops import mlp
from deepfepe_tpu_torch.train import config_from_dict, learning_rate, make_optimizer, train_step
from deepfepe_tpu_torch.train.engine import update_count
from deepfepe_tpu_torch.utils.weights import deepfnet_state_from_flax
from _torch_threads import one_torch_thread  # noqa: F401

SIZE = (376, 1241)
DEPTH, N, B = 2, 64, 2
LR = 1e-4


def _load_chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _load_chip_smoke()  # the card's checks, which import torch only when called


def _cfg_dict(mode, epi_min=1e-3, pallas=False):
    return {
        "data": {"batch_size": B, "good_num": N},
        "model": {"depth": DEPTH, "if_quality": True, "if_qt_loss": mode == "qt",
                  "mlp_dtype": "bfloat16" if pallas else "float32",
                  "use_pallas_mlp": pallas},
        "training": {"learning_rate": LR, "skip_optimizer_enable": True,
                     "skip_optimizer_epi_min": epi_min},
    }


@pytest.fixture(scope="module")
def batch():
    return SyntheticPairs(image_size=SIZE, good_num=N, seed=4).batch(B)


def _tb(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _keep_grads():
    """A JAX 'optimizer' that leaves the parameters and keeps the gradient
    as its state, so one compiled `make_train_step` call yields both."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_step(batch, d):
    """JAX parameters, gradients, parameters after one optax Adam step on
    those gradients, and the step's metrics."""
    cfg = jconfig_from_dict(d)
    m = cfg.model
    net = JDeepFNet(depth=DEPTH, image_size=SIZE, if_quality=True, sign_canonical=True,
                    mlp_dtype=getattr(jnp, m.mlp_dtype), use_pallas_mlp=m.use_pallas_mlp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), jb))
    tx = _keep_grads()
    state, metrics = make_train_step(net, tx, cfg)(TrainState.create(params, tx), jb, 0.1, 0.5)
    grads = jax.device_get(state.opt_state)
    adam = jmake_optimizer(cfg)
    updates, _ = adam.update(grads, adam.init(params), params)
    return params, grads, optax.apply_updates(params, updates), jax.device_get(metrics)


def _port_step(batch, d, params):
    cfg = config_from_dict(d)
    m = cfg.model
    net = DeepFNet(depth=DEPTH, image_size=SIZE, if_quality=True, sign_canonical=True,
                   mlp_dtype=getattr(torch, m.mlp_dtype), use_pallas_mlp=m.use_pallas_mlp)
    net.load_state_dict(deepfnet_state_from_flax(params), strict=True)
    opt = make_optimizer(net, cfg)
    tb = _tb(batch)
    metrics = train_step(net, opt, tb, cfg, 0.1, 0.5)
    grads = {k: p.grad for k, p in net.named_parameters()}
    return net, opt, grads, metrics


def _frob(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.mark.parametrize("mode", ["F", "qt"])
def test_train_step_matches_jax_f32(batch, mode):
    d = _cfg_dict(mode)
    params, jgrads, jafter, jm = _jax_step(batch, d)
    net, opt, grads, m = _port_step(batch, d, params)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4 * abs(float(jm["loss"]))
    np.testing.assert_allclose(m["loss_min_batch"].numpy(), np.asarray(jm["loss_min_batch"]),
                               rtol=1e-4)
    assert float(m["nonfinite"]) == float(jm["nonfinite"]) == 0.0
    assert bool(m["skipped"]) == bool(jm["skipped"]) is False
    jg = deepfnet_state_from_flax(jgrads)
    before, after = deepfnet_state_from_flax(params), deepfnet_state_from_flax(jafter)
    for k, p in net.named_parameters():
        g, ref = grads[k], jg[k]
        scale = ref.abs().max().item()
        if scale > 1e-6:
            assert (g - ref).abs().max().item() <= 2e-3 * scale, k
        else:  # zero up to rounding in both (hidden and final biases)
            assert g.abs().max().item() <= 1e-6, k
        d_port, d_jax = p.detach() - before[k], after[k] - before[k]
        assert (d_port - d_jax).abs().max().item() <= 2 * LR * (1 + 1e-6)
        live = ref.abs() > 1e-6
        if live.any():
            assert (d_port - d_jax)[live].abs().max().item() <= 1e-2 * LR, k


def _jax_call(c):
    """JAX `fused_pointnet_mlp` (interpret mode) on a recorded call: logits
    and the VJP for its cotangent, in the port's layout."""
    a = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    args = (a(c["x"]), [a(W.T.contiguous()) for W in c["Ws"]], [a(g) for g in c["gammas"]],
            [a(b) for b in c["betas"]], (a(c["Wf"].T.contiguous()), a(c["bf"])))
    out, vjp = jax.vjp(lambda *z: jfused(*z, c["slope"])[..., :1], *args)
    dx, dW, dg, db, (dWf, dbf) = vjp(a(c["g"]))
    t = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    grads = [t(dx), *[t(w).T for w in dW], *map(t, dg), *map(t, db), t(dWf).T, t(dbf)]
    return t(out), grads


def test_train_step_matches_jax_fused_mlp(batch):
    d = _cfg_dict("F", pallas=True)
    params, _, _, jm = _jax_step(batch, d)
    with mlp.record_calls() as calls:
        net, _, grads, m = _port_step(batch, d, params)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 2e-2 * abs(float(jm["loss"]))
    np.testing.assert_allclose(m["loss_min_batch"].numpy(), np.asarray(jm["loss_min_batch"]),
                               rtol=2e-2)
    assert float(m["nonfinite"]) == float(jm["nonfinite"]) == 0.0
    assert bool(m["skipped"]) == bool(jm["skipped"])
    assert len(calls) == DEPTH and sum("dx" in c for c in calls) == DEPTH - 1

    state = deepfnet_state_from_flax(params)
    L = len(calls[0]["Ws"])
    keys = SMOKE.mlp_param_keys(L)
    plain_sum, jax_sum, g_abs = {}, {}, {}
    for c in calls:
        name = SMOKE.call_owner(c, state)
        jout, jgrads = _jax_call(c)
        plain = SMOKE.flat_grads(mlp.reference_pointnet_mlp_bwd(
            c["x"], c["g"], c["Ws"], c["gammas"], c["betas"], c["Wf"], c["slope"]))
        scale = jout.abs().max()
        assert (c["out"] - jout).abs().max() <= 3e-2 * scale, name
        if "dx" in c:
            torch.testing.assert_close(c["dx"], plain[0], rtol=0, atol=0)
            assert _frob(c["dx"], jgrads[0]) <= 0.3, name
        for k, a, b in zip(keys, plain[1:], jgrads[1:]):
            plain_sum[f"{name}.{k}"] = plain_sum.get(f"{name}.{k}", 0.0) + a.double()
            jax_sum[f"{name}.{k}"] = jax_sum.get(f"{name}.{k}", 0.0) + b.double()
        g_abs[name] = g_abs.get(name, 0.0) + float(c["g"].abs().sum())

    for k, ref in plain_sum.items():
        g = grads[k].double()
        assert _frob(g, ref) <= 1e-6, k  # the wiring: each parameter gets its own sum
        name, key = k.split(".", 1)
        if key == keys[-1]:  # the final bias: the sum of g, zero under the softmax
            assert float(jax_sum[k].abs().max()) <= 2**-9 * g_abs[name]
            assert float(g.abs().max()) <= 2**-8 * g_abs[name], k
        else:
            assert _frob(g, jax_sum[k]) <= 0.3, k
    for i in range(L):  # hidden biases: never read on the fused route
        for name in ("input_weights", "update_weights"):
            assert float(grads[f"{name}.fw.{3 * i}.bias"].abs().max()) == 0.0


@pytest.mark.parametrize("fault", ["none", "dx_zero", "dgamma_dbeta_swapped"])
def test_card_step_check_catches_planted_faults(batch, monkeypatch, fault):
    backward = staticmethod(mlp.FusedPointNetMLP.backward)
    monkeypatch.setattr(mlp.FusedPointNetMLP, "backward", backward)  # restored after the test
    SMOKE.plant(fault)
    cfg = config_from_dict(_cfg_dict("F", pallas=True))
    net = DeepFNet(depth=DEPTH, image_size=SIZE, if_quality=True, mlp_dtype=torch.bfloat16,
                   use_pallas_mlp=True)
    net.reset_parameters(torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in net.state_dict().items()}
    with mlp.record_calls() as calls:
        train_step(net, make_optimizer(net, cfg), _tb(batch), cfg, 0.1, 0.5)
    grads = {k: p.grad.double() for k, p in net.named_parameters()}
    report = SMOKE.fused_step_report(calls, state, grads)
    assert report["within_bars"] is (fault == "none")
    if fault == "dx_zero":
        assert report["dx_worst"]["kp"] == 1.0
    elif fault == "dgamma_dbeta_swapped":
        assert report["param_worst"]["kp"] > 0.5
    else:
        assert report["param_worst"]["kp"] <= 1e-6 and report["dx_worst"]["kp"] == 0.0


def test_skip_optimizer_leaves_a_solved_batch(batch):
    cfg, net, opt = _net_and_opt(_cfg_dict("F", epi_min=1.0))  # every batch counts as solved
    params = {k: v.clone() for k, v in net.state_dict().items()}
    m = train_step(net, opt, _tb(batch), cfg, 0.1, 0.5)
    assert bool(m["skipped"]) and float(m["nonfinite"]) == 0.0
    assert bool(m["loss_min_batch"].min() <= 1.0)
    for k, v in net.state_dict().items():
        assert torch.equal(v, params[k]), k
    assert update_count(opt) == 0 and not opt.state


def _net_and_opt(d):
    cfg = config_from_dict(d)
    net = DeepFNet(depth=DEPTH, image_size=SIZE, if_quality=True, mlp_dtype=torch.float32)
    net.reset_parameters(torch.Generator().manual_seed(0))
    return cfg, net, make_optimizer(net, cfg)


def test_nan_batch_skips_the_whole_update(batch):
    cfg, net, opt = _net_and_opt(_cfg_dict("F", epi_min=-1.0))
    tb = _tb(batch)
    m = train_step(net, opt, tb, cfg, 0.1, 0.5)
    assert float(m["nonfinite"]) == 0.0 and update_count(opt) == 1
    params = {k: v.clone() for k, v in net.state_dict().items()}
    state = {i: {k: v.clone() for k, v in s.items()} for i, s in opt.state_dict()["state"].items()}

    bad = dict(tb)
    bad["matches_xy_ori"] = tb["matches_xy_ori"].clone()
    bad["matches_xy_ori"][0, :8] = float("nan")
    m = train_step(net, opt, bad, cfg, 0.1, 0.5)
    assert float(m["nonfinite"]) == 1.0 and not np.isfinite(float(m["loss"]))
    for k, v in net.state_dict().items():
        assert torch.equal(v, params[k]), k
    for i, s in opt.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, state[i][k]), (i, k)
    assert update_count(opt) == 1

    m = train_step(net, opt, tb, cfg, 0.1, 0.5)
    assert float(m["nonfinite"]) == 0.0 and update_count(opt) == 2


def test_staircase_learning_rate_matches_optax(batch):
    d = _cfg_dict("F", epi_min=-1.0)
    d["training"].update({"lr_decay_rate": 0.5, "lr_decay_step": 2})
    cfg = config_from_dict(d)
    sched = optax.exponential_decay(LR, transition_steps=2000, decay_rate=0.5, staircase=True)
    for count in (0, 1, 1999, 2000, 3999, 4000, 10_000):
        assert learning_rate(cfg, count) == pytest.approx(float(sched(count)), rel=1e-6)
    assert learning_rate(config_from_dict({"training": {"learning_rate": 3e-4}}), 10**6) == 3e-4

    cfg, net, opt = _net_and_opt(d)
    opt.param_groups[0]["lr"] = 1.0  # overwritten from the update count before each step
    train_step(net, opt, _tb(batch), cfg, 0.1, 0.5)
    assert opt.param_groups[0]["lr"] == learning_rate(cfg, 0) == LR
    for s in opt.state.values():  # every parameter's state is there and stepped once
        assert int(s["step"]) == 1
    assert len(opt.state) == len(list(net.parameters()))


def test_eval_step_uses_the_final_clamps(batch, monkeypatch):
    engine = importlib.import_module("deepfepe_tpu_torch.train.engine")
    seen = []
    monkeypatch.setattr(engine, "rt_loss",
                        lambda *a, loss_q_clamp, loss_t_clamp: seen.append(
                            (loss_q_clamp, loss_t_clamp)) or {
                            k: torch.zeros(DEPTH, B) if k.endswith("layers") else torch.zeros(())
                            for k in ("loss_q", "loss_t", "R_angle_error_mean",
                                      "t_angle_error_mean", "q_l2_layers", "t_l2_layers")})
    cfg, net, _ = _net_and_opt(_cfg_dict("qt"))
    engine.eval_step(net, _tb(batch), cfg)
    assert seen == [(0.001, 0.1)]
