"""Shared set-up of the joint-step parity tests (tests/test_torch_joint*.py):
one joint SuperPoint + DeepF step through the port and through the JAX
package on the same batch and weights.

Weights are made by the port from seeds and carried to the JAX package by
its own reference importers (`convert_superpoint_state`,
`convert_superpoint_gauss2_state`, `convert_deepf_state`); gauss2 running
statistics come from a calibration batch (`port_nets`). The JAX step runs with an
'optimizer' that leaves the parameters and keeps the gradient as its
state, so one compiled step yields the gradients, the metrics and the
BatchNorm write-back (tests/test_torch_train.py's device).
"""

import contextlib
import copy
import types

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from deepfepe_tpu.frontend import FrontendParams as JFrontendParams
from deepfepe_tpu.frontend import get_matches_from_sp as jget_matches
from deepfepe_tpu.frontend import superpoint as jsuperpoint
from deepfepe_tpu.frontend.superpoint import SuperPointNet as JSuperPointNet
from deepfepe_tpu.frontend.superpoint import SuperPointNetGauss2 as JGauss2
from deepfepe_tpu.models import DeepFNet as JDeepFNet
from deepfepe_tpu.train import Config as JConfig
from deepfepe_tpu.train.joint import JointTrainState, make_joint_train_step
from deepfepe_tpu.utils.torch_import import (convert_deepf_state, convert_superpoint_gauss2_state,
                                             convert_superpoint_state)
from deepfepe_tpu_torch.data import SyntheticImagePairs
from deepfepe_tpu_torch.frontend import FrontendParams, SuperPointNet, SuperPointNetGauss2
from deepfepe_tpu_torch.frontend import get_matches_from_sp
from deepfepe_tpu_torch.frontend.superpoint import reset_superpoint
from deepfepe_tpu_torch.models import DeepFNet
from deepfepe_tpu_torch.train import config_from_dict
from deepfepe_tpu_torch.train.joint import joint_train_step, make_joint_state
from deepfepe_tpu_torch.utils.weights import (deepfnet_state_from_flax, superpoint_state_from_flax,
                                              to_reference_layout)

# tests/test_joint.py's size.
SIZE, B, N, DEPTH = (64, 96), 2, 64, 2
FP = dict(out_num_points=N, conf_thresh=1e-4)


def batch(seed=3):
    return SyntheticImagePairs(image_size=SIZE, seed=seed).batch(B)


def port_nets(kind: str):
    """Seeded port nets: (SuperPoint of `kind`, DeepFNet). A gauss2 net's
    running statistics are those of a calibration batch (one train-mode
    forward at momentum 1 on other frames): with the initial (0, 1) or
    random statistics the untrained net gives nearly equal descriptors
    everywhere, the matches' distances differ by less than float32 rounding
    and the weighted 8-point fit on them is near-degenerate, so the loss
    moves by percents with rounding in the frontend and no two float32
    implementations agree on it."""
    g = torch.Generator().manual_seed(0)
    sp = reset_superpoint(SuperPointNetGauss2() if kind == "gauss2" else SuperPointNet(), g)
    bns = [m for m in sp.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    if bns:
        calib = torch.from_numpy(batch(seed=11)["imgs_grey"]).reshape(2 * B, *SIZE, 1)
        for m in bns:
            m.momentum = 1.0
        with torch.no_grad():
            sp.train()(calib)
        for m in bns:
            m.momentum = 0.1
            m.num_batches_tracked.zero_()
    deepf = DeepFNet(depth=DEPTH, image_size=SIZE, if_quality=True, sign_canonical=True)
    deepf.reset_parameters(torch.Generator().manual_seed(1))
    return sp.eval(), deepf


def jax_variables(sp, deepf):
    """The port nets' weights as the JAX package's variables (copies: the
    port's optimizer later updates its tensors in place)."""
    sd = {k: v.numpy().copy() for k, v in sp.state_dict().items()}
    convert = convert_superpoint_gauss2_state if isinstance(sp, SuperPointNetGauss2) \
        else convert_superpoint_state
    dsd = {k: v.numpy().copy() for k, v in to_reference_layout(deepf.state_dict()).items()}
    return convert(sd), convert_deepf_state(dsd)


def port_cfg(min_matches=0.0):
    return config_from_dict({"data": {"batch_size": B, "good_num": N},
                             "model": {"depth": DEPTH, "if_quality": True,
                                       "mlp_dtype": "float32"},
                             "training": {"learning_rate": 1e-4, "min_matches": min_matches}})


def jax_cfg(min_matches=0.0):
    cfg = JConfig()
    cfg.model.depth = DEPTH
    cfg.model.if_quality = True
    cfg.data.good_num = N
    cfg.training.min_matches = min_matches
    return cfg


def keep_grads():
    """A JAX 'optimizer' that leaves the parameters and keeps the gradient
    as its state (zero while the update guard skips)."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def match_set(m) -> set:
    val, i1, i2 = (np.asarray(a) for a in (m.valid, m.idx1, m.idx2))
    return {(b, int(i1[b, k]), int(i2[b, k])) for b in range(val.shape[0])
            for k in range(val.shape[1]) if val[b, k]}


def match_order(m) -> list:
    """The matches as ordered (idx1, idx2) lists per pair: the order decides
    which matches the padded slots repeat."""
    val, i1, i2 = (np.asarray(a) for a in (m.valid, m.idx1, m.idx2))
    return [[(int(a), int(c)) for a, c, v in zip(i1[b], i2[b], val[b]) if v]
            for b in range(val.shape[0])]


def _float64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


class _Float64Numpy(types.ModuleType):
    """jax.numpy with float32 standing for float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@contextlib.contextmanager
def superpoint_float64():
    """The JAX package's SuperPoint module (deepfepe_tpu/frontend/
    superpoint.py) casts the heads' outputs (:61-66, :226-231) and the
    train-mode BatchNorm statistics (:133) to float32 whatever its dtype.
    Inside the block that module's `jnp.float32` is float64, its code
    unchanged, so a float64 step is float64 through the SuperPoint."""
    saved = jsuperpoint.jnp
    jsuperpoint.jnp = _Float64Numpy("jax.numpy")
    try:
        yield
    finally:
        jsuperpoint.jnp = saved


def run_variant(kind: str, bn_mode: str, fused: bool, extra_matches: float = 0.0,
                batch_seed: int = 3):
    """One joint step (train_deepf and train_sp on) through both packages
    in float64, after a float32 pass of both frontends for the discrete
    part: the ordered match lists must agree in float32 too.

    Float64 takes the comparison off float32's rounding, which moves the
    step's gradients by percents at this size: with untrained nets the
    weighted 8-point fits are near-degenerate, and the F-loss's |s| and
    clamp and the weight MLP's leaky ReLUs have kinks within float32's
    reach, where the gradient jumps. The JAX SuperPoint runs under
    `superpoint_float64`: with its float32 casts the float64 steps' leaves
    differ by up to 7e-3 (gauss2, train mode) and by percents (plain net),
    without them by under 2e-4.

    The update guard's floor is the port's fewest matches in a pair (in
    float32) plus `extra_matches` (0: exactly at the floor, the step goes
    on; > 0: both skip). `fused` routes the port's SuperPoint through the
    fused forward with every 3x3 layer on the K5 Function (the pixel
    threshold at 0). The JAX package takes its module forward, its own
    route on the CPU: its fused route's plain-conv branch
    (`conv3x3_affine_relu_ref`) takes the ReLU as jnp.maximum(z, 0), whose
    gradient at z == 0 is 1/2 where nn.relu's, its Pallas kernel's and the
    port's are 0 (ROADMAP Queue 3), and the synthetic frames have
    exact-zero regions."""
    b = batch(batch_seed)
    f32 = _Pass(kind, bn_mode, fused, b, float64=False)
    r32 = f32.matches()
    floor = r32.pop("fewest") + extra_matches
    with superpoint_float64():
        f64 = _Pass(kind, bn_mode, fused, b, float64=True)
        out = f64.matches()
        out.pop("fewest")
        out.update(f64.step(floor))
    out["f32"] = r32
    return out


class _Pass:
    """Both packages' nets and batch in one precision."""

    def __init__(self, kind, bn_mode, fused, b, float64):
        dt, self.jdt = (torch.float64, jnp.float64) if float64 else (torch.float32, jnp.float32)
        self.kind, self.bn_mode = kind, bn_mode
        self.bn_train = bn_mode == "train" and kind == "gauss2"
        self.fp = FrontendParams(**FP, conv_backend="fused" if fused else "flax",
                                 conv_impl="pallas")
        self.jfp = JFrontendParams(**FP, conv_backend="flax")
        self.jsp = (JGauss2 if kind == "gauss2" else JSuperPointNet)(dtype=self.jdt)
        sp, deepf = port_nets(kind)
        self.jsp_vars, self.jdeepf_vars = jax_variables(sp, deepf)
        self.sp, self.deepf = sp.to(dt), deepf
        self.tb = {k: torch.from_numpy(v) for k, v in b.items()}
        self.jb = {k: jnp.asarray(v) for k, v in b.items()}
        if float64:
            self.deepf = deepf.double()
            self.deepf.input_weights.dtype = self.deepf.update_weights.dtype = torch.float64
            self.tb = {k: v.double() if v.is_floating_point() else v for k, v in self.tb.items()}
            self.jb = {k: v.astype(jnp.float64) if jnp.issubdtype(v.dtype, jnp.floating) else v
                       for k, v in self.jb.items()}
            self.jsp_vars, self.jdeepf_vars = _float64(self.jsp_vars), _float64(self.jdeepf_vars)

    @contextlib.contextmanager
    def _k5_everywhere(self):
        import importlib

        sp_fused = importlib.import_module("deepfepe_tpu_torch.frontend.sp_fused")
        saved = sp_fused.MIN_PX_PALLAS
        sp_fused.MIN_PX_PALLAS = 0
        try:
            yield
        finally:
            sp_fused.MIN_PX_PALLAS = saved

    def matches(self) -> dict:
        """Both frontends' matches, on a copy of the port's net."""
        frames = (self.tb["imgs_grey"][:, 0], self.tb["imgs_grey"][:, 1])
        with self._k5_everywhere(), torch.no_grad():
            port_m = get_matches_from_sp(copy.deepcopy(self.sp), frames, self.fp,
                                         bn_train=self.bn_train)["matches"]
        jm = jax.jit(lambda v, a, c: jget_matches(self.jsp, v, (a, c), self.jfp,
                                                  bn_train=self.bn_train))(
            self.jsp_vars, self.jb["imgs_grey"][:, 0], self.jb["imgs_grey"][:, 1])["matches"]
        return {"port_order": match_order(port_m), "jax_order": match_order(jm),
                "port_matches": match_set(port_m),
                "fewest": float(port_m.valid.sum(-1).min())}

    def step(self, floor: float) -> dict:
        """One joint step through each package, the guard at `floor`."""
        sp, deepf = self.sp, self.deepf
        buffers_before = {k: v.clone() for k, v in sp.named_buffers()}
        cfg = port_cfg(floor)
        with self._k5_everywhere():
            metrics = joint_train_step(make_joint_state(deepf, sp, cfg), self.tb, self.fp, cfg,
                                       0.1, 0.5, bn_mode=self.bn_mode)
        jdeepf = JDeepFNet(depth=DEPTH, image_size=SIZE, if_quality=True, sign_canonical=True,
                           mlp_dtype=self.jdt)
        tx = keep_grads()
        step = make_joint_train_step(jdeepf, self.jsp, self.jfp, tx, tx, jax_cfg(floor),
                                     bn_mode=self.bn_mode)
        jstate, jmetrics = jax.device_get(step(
            JointTrainState.create(self.jdeepf_vars, self.jsp_vars, tx, tx), self.jb, 0.1, 0.5))
        return {
            "sp_keys": [k for k, _ in sp.named_parameters()],
            "deepf_keys": [k for k, _ in deepf.named_parameters()],
            "metrics": {k: float(v) for k, v in metrics.items() if v.dim() == 0},
            "jax_metrics": {k: float(v) for k, v in jmetrics.items() if np.ndim(v) == 0},
            "grads": {k: p.grad.numpy() for k, p in
                      [*sp.named_parameters(), *deepf.named_parameters()]},
            "jax_grads": {k: v.numpy() for k, v in
                          {**deepfnet_state_from_flax(jstate.deepf_opt),
                           **superpoint_state_from_flax(jstate.sp_opt)}.items()},
            "buffers_before": buffers_before, "buffers_after": dict(sp.named_buffers()),
            "jax_buffers_after": superpoint_state_from_flax(jstate.sp_params)
            if self.kind == "gauss2" else {}}


def _rel(a, b):
    return abs(a - b) / abs(b)


def assert_step_matches(r):
    """Port against JAX on one joint step. The discrete part exactly: the
    ordered match lists (the order decides which matches the padded slots
    repeat) in float32 and in float64, the match counts and the guard's
    decision. Then, in float64, the loss within 1e-4 (relative), the
    gradient norms within 1e-3 (relative) and every gradient leaf within
    1e-3 of its largest JAX entry; a leaf whose largest JAX entry is under
    1e-4 of its net's largest is zero in exact arithmetic (biases ahead of
    train-mode BatchNorm, hidden biases under InstanceNorm) and holds at
    1e-4 of the net's largest entry."""
    f32 = r["f32"]
    for x in (r, f32):
        assert x["port_order"] == x["jax_order"] and len(x["port_matches"]) > 10
    assert r["port_order"] == f32["port_order"]
    m, jm = r["metrics"], r["jax_metrics"]
    for k in ("num_matches", "min_matches_item", "skipped_update"):
        assert m[k] == jm[k], (k, m[k], jm[k])
    assert _rel(m["loss"], jm["loss"]) <= 1e-4, (m["loss"], jm["loss"])
    for k in ("g_deepf_norm", "g_sp_norm"):
        assert _rel(m[k], jm[k]) <= 1e-3, (k, m[k], jm[k])
    if jm["skipped_update"]:
        return
    for net in ("sp", "deepf"):
        keys = r[f"{net}_keys"]
        scale = max(float(np.abs(r["jax_grads"][k]).max()) for k in keys)
        for k in keys:
            w, g = r["jax_grads"][k], r["grads"][k]
            own = float(np.abs(w).max())
            if own < 1e-4 * scale:
                assert float(np.abs(g).max()) <= 1e-4 * scale, (k, own, scale)
                continue
            err = float(np.abs(g - w).max()) / own
            assert err <= 1e-3, (k, err)
