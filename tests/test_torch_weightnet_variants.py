"""Port parity: the weight-net variants and differentiable RANSAC.

Inputs are made with numpy from a seed; parameters go across from the JAX
package's trees (`utils/weights.py`), every norm affine and bias moved off
its initial value. All in float64:

- `if_des` DeepFNet (the batch's 'des' in the weight nets' input, C_in =
  4 + 1 + 256): F_est, each layer's weights and logits within 1e-6 of the
  JAX net's, and the gradient of sum(F_est²) with respect to the
  descriptors and every parameter within 1e-6 of the largest entry.
  With `use_pallas_mlp` the 261- and 264-wide inputs never reach the fused
  MLP (its entry point is replaced by one that fails).
- `ErrorEstimatorFeatFusion`, `ErrorEstimatorFeatFusion2Head` and the
  BatchNorm `ErrorEstimator` (running and batch statistics): outputs and
  input gradients within 1e-9 relative (the JAX package's ErrorEstimator
  bar in tests/test_torch_deepfnet.py), parameter gradients within 1e-6
  (they cross through the state converters, which store float32); the
  BatchNorm nets also through the JAX package's reference-layout export
  into `DeepFNet(if_bn=True)`.
- DSAC on the JAX package's draws: every output within 1e-9, and the
  expected loss's gradient with respect to the points within 1e-6 of its
  largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import synthetic_pair
from deepfepe_tpu.data.synthetic import SyntheticPairs
from deepfepe_tpu.models.deepfnet import DeepFNet as JDeepFNet
from deepfepe_tpu.models.dsac import dsac_essential as j_dsac
from deepfepe_tpu.models.error_estimator import (
    ErrorEstimator as JErrorEstimator,
    ErrorEstimatorFeatFusion as JFeatFusion,
    ErrorEstimatorFeatFusion2Head as JFeatFusion2Head,
)
from deepfepe_tpu.utils.torch_import import export_deepf_state
from deepfepe_tpu_torch.models import (DeepFNet, ErrorEstimator, ErrorEstimatorFeatFusion,
                                       ErrorEstimatorFeatFusion2Head, dsac_essential)
from deepfepe_tpu_torch.ops import mlp
from deepfepe_tpu_torch.train.loop import load_checkpoint
from deepfepe_tpu_torch.utils.weights import (deepfnet_state_from_flax,
                                              error_estimator_state_from_flax,
                                              feat_fusion_2head_state_from_flax,
                                              feat_fusion_state_from_flax)
from _torch_threads import one_torch_thread  # noqa: F401

SIZE = (376, 1241)
D = 256


def _randomize(tree, seed=0):
    """Norm scales in [0.5, 1.5], biases in [-0.2, 0.2], BatchNorm means
    in [-0.3, 0.3] and variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        name = getattr(path[-1], "key", "")
        if name in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
        if name in ("bias", "mean"):
            return jnp.asarray(rng.uniform(-0.3, 0.3, x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


def _leaves_close(got: dict, want: dict, rel: float):
    """Each leaf within `rel` of its largest entry; a leaf whose gradient is
    zero but for rounding (a Linear bias before an InstanceNorm) within
    `rel` of 1e-6 of the largest entry of all leaves."""
    assert set(got) == set(want), set(got) ^ set(want)
    top = max(np.abs(np.asarray(w)).max() for w in want.values())
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-6 * top), err_msg=k)


def _torch_grads(net) -> dict:
    return {k: p.grad.numpy() for k, p in net.named_parameters()}


@pytest.fixture(scope="module")
def des_batch():
    b = SyntheticPairs(image_size=SIZE, good_num=64, seed=4).batch(2)
    rng = np.random.RandomState(1)
    return {"matches_xy_ori": b["matches_xy_ori"].astype(np.float64), "quality": b["quality"],
            "des": rng.rand(2, 64, D)}


@pytest.fixture(scope="module")
def des_runs(des_batch):
    """The JAX and port if_des DeepFNets (depth 3, float64) on one batch:
    outputs and the gradients of sum(F_est²)."""
    jnet = JDeepFNet(depth=3, image_size=SIZE, if_quality=True, if_des=True, des_size=D,
                     mlp_dtype=jnp.float64, sign_canonical=True)
    jb = {k: jnp.asarray(v) for k, v in des_batch.items()}
    params = _randomize(jax.jit(jnet.init)(jax.random.PRNGKey(1), jb), seed=2)

    def f(p, des):
        out = jnet.apply(p, {**jb, "des": des})
        return jnp.sum(out["F_est"] ** 2), out

    (_, jout), (gp, gdes) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jb["des"])
    net = DeepFNet(depth=3, image_size=SIZE, if_quality=True, if_des=True, des_size=D,
                   mlp_dtype=torch.float64, sign_canonical=True).double()
    net.load_state_dict(deepfnet_state_from_flax(params), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in des_batch.items()}
    tb["des"].requires_grad_(True)
    tout = net(tb)
    (tout["F_est"] ** 2).sum().backward()
    return {"jax": jout, "port": tout, "jax_grads": (deepfnet_state_from_flax(gp), gdes),
            "port_grads": (_torch_grads(net), tb["des"].grad.numpy())}


def test_deepfnet_if_des_matches_jax(des_runs):
    j, t = des_runs["jax"], des_runs["port"]
    assert t["weights_layers"].shape == (3, 2, 64)
    for k in ("F_est", "weights_layers", "logits_layers"):
        ref = np.asarray(j[k])
        np.testing.assert_allclose(t[k].detach().numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=k)


def test_deepfnet_if_des_gradients_match_jax(des_runs):
    (gj, gdes_j), (gt, gdes_t) = des_runs["jax_grads"], des_runs["port_grads"]
    _leaves_close(gt, {k: v.numpy() for k, v in gj.items()}, 1e-6)
    _leaves_close({"des": gdes_t}, {"des": gdes_j}, 1e-6)
    assert np.abs(gdes_t).max() > 0


def test_if_des_widths_skip_the_fused_mlp(des_batch, monkeypatch):
    """C_in 261 and 264 exceed the fused MLP's 128: with use_pallas_mlp the
    weight nets run layer by layer, as the JAX package's routing does."""
    def refuse(*a, **k):
        raise AssertionError("the fused MLP was called")

    monkeypatch.setattr(mlp, "fused_pointnet_mlp", refuse)
    monkeypatch.setattr("deepfepe_tpu_torch.models.error_estimator.fused_pointnet_mlp", refuse)
    net = DeepFNet(depth=2, image_size=SIZE, if_quality=True, if_des=True,
                   mlp_dtype=torch.bfloat16, use_pallas_mlp=True)
    assert net.des_size == D  # the dump loader's width when des_size is 0
    assert net.input_weights.fw[0].in_features == 261
    assert net.update_weights.fw[0].in_features == 264
    with torch.no_grad():
        out = net({k: torch.from_numpy(v).float() for k, v in des_batch.items()})
    assert torch.isfinite(out["F_est"]).all()


def _head_case(kind, rng):
    pts, des = rng.rand(2, 40, 7), rng.rand(2, 40, 12)
    if kind == "fusion":
        jnet, tnet, conv = (JFeatFusion(output_size=1), ErrorEstimatorFeatFusion(7, 12, 1),
                            feat_fusion_state_from_flax)
    else:
        jnet, tnet, conv = (JFeatFusion2Head(output_size=1),
                            ErrorEstimatorFeatFusion2Head(7, 12, 1), feat_fusion_2head_state_from_flax)
    return pts, des, jnet, tnet.double(), conv


@pytest.mark.parametrize("kind", ["fusion", "fusion_2head"])
def test_feat_fusion_heads_match_jax(rng, kind):
    pts, des, jnet, tnet, conv = _head_case(kind, rng)
    params = _randomize(jnet.init(jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(des)))

    def f(p, a, b):
        y = jnet.apply(p, a, b)
        return jnp.sum(jnp.sin(y)), y

    (_, yj), (gp, ga, gb) = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(pts), jnp.asarray(des))
    tnet.load_state_dict(conv(params["params"]), strict=True)
    a, b = torch.from_numpy(pts).requires_grad_(True), torch.from_numpy(des).requires_grad_(True)
    yt = tnet(a, b)
    torch.sin(yt).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(yj)).max())
    _leaves_close(_torch_grads(tnet), {k: v.numpy() for k, v in conv(gp["params"]).items()},
                  1e-6)
    _leaves_close({"pts": a.grad.numpy(), "des": b.grad.numpy()},
                  {"pts": np.asarray(ga), "des": np.asarray(gb)}, 1e-9)


def _bn_variables(x, seed=0):
    jnet = JErrorEstimator(output_size=1, if_bn=True, dtype=jnp.float64)
    return jnet, _randomize(jnet.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)


@pytest.mark.parametrize("train", [False, True], ids=["running_stats", "batch_stats"])
def test_bn_error_estimator_matches_jax(rng, train):
    x = rng.rand(2, 50, 5)
    jnet, variables = _bn_variables(x)
    stats = variables["batch_stats"]

    def f(p, a):
        v = {"params": p, "batch_stats": stats}
        y = (jnet.apply(v, a, train=True, mutable=["batch_stats"])[0] if train
             else jnet.apply(v, a))
        return jnp.sum(jnp.sin(y)), y

    (_, yj), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(x))
    tnet = ErrorEstimator(5, 1, dtype=torch.float64, if_bn=True).double()
    tnet.load_state_dict(error_estimator_state_from_flax(variables["params"], "", stats),
                         strict=True)
    assert "fw.20.bias" not in tnet.state_dict()  # the BatchNorm net's last Linear
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tnet(xt, train=train)
    torch.sin(yt).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(yj)).max())
    want = {k: v.numpy() for k, v in error_estimator_state_from_flax(gp, "", stats).items()
            if "running" not in k and "num_batches" not in k}
    _leaves_close(_torch_grads(tnet), want, 1e-6)
    _leaves_close({"x": xt.grad.numpy()}, {"x": np.asarray(gx)}, 1e-9)


def test_bn_deepfnet_from_a_reference_checkpoint(rng, tmp_path):
    """The JAX package's reference-layout export of BatchNorm weight nets
    (`export_deepf_state(..., if_bn=True)`, fw.<4i+k>) loads strict into
    `DeepFNet(if_bn=True)`; its input weight net gives the JAX net's
    logits."""
    x = rng.rand(2, 50, 5)
    jnet, variables = _bn_variables(x)
    _, update = _bn_variables(rng.rand(2, 50, 8), seed=1)  # 5 + weights, residuals
    nets = {"input_weights": variables, "update_weights": update}
    deepf = {kind: {n: v[kind] for n, v in nets.items()} for kind in ("params", "batch_stats")}
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in
          export_deepf_state(deepf, if_bn=True).items()}
    assert "input_weights.fw.1.running_mean" in sd and "input_weights.fw.20.weight" in sd
    path = tmp_path / "deepF_bn.pth.tar"
    torch.save({"n_iter": 0, "model_state_dict": sd}, path)
    net = DeepFNet(depth=2, image_size=SIZE, if_quality=True, if_bn=True).eval()
    load_checkpoint(str(path), net)
    assert net.input_weights.if_bn and net.update_weights.if_bn
    net = net.double()
    net.input_weights.dtype = torch.float64  # the config's MLP dtype is float32
    with torch.no_grad():
        yt = net.input_weights(torch.from_numpy(x)).numpy()
    yj = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(yt, yj, rtol=1e-9, atol=1e-9 * np.abs(yj).max())


@pytest.fixture(scope="module")
def dsac_case():
    s = synthetic_pair(np.random.RandomState(7), n=100, noise=0.3, outlier_frac=0.3)
    K_inv = np.linalg.inv(s["K"])
    xh = lambda x: (np.hstack([x, np.ones((len(x), 1))]) @ K_inv.T)[:, :2]
    E_gt = s["E"] / np.linalg.norm(s["E"])
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (64, 10), 0, 100))
    return xh(s["x1"]), xh(s["x2"]), E_gt, idx


def _loss(lib, E_gt):
    def loss_fn(E):
        En = E / (lib.linalg.norm(E) + 1e-9)
        return lib.minimum(((En - E_gt) ** 2).sum(), ((En + E_gt) ** 2).sum())
    return loss_fn


def test_dsac_matches_jax(dsac_case):
    x1, x2, E_gt, idx = dsac_case
    jloss = _loss(jnp, jnp.asarray(E_gt))

    def f(a):
        out = j_dsac(a, jnp.asarray(x2), jax.random.PRNGKey(3), loss_fn=jloss)
        return out["exp_loss"], out

    (_, want), gj = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(x1))
    a = torch.from_numpy(x1).requires_grad_(True)
    got = dsac_essential(a, torch.from_numpy(x2), loss_fn=_loss(torch, torch.from_numpy(E_gt)),
                         idx=torch.from_numpy(idx))
    got["exp_loss"].backward()
    assert float(got["top_loss"]) < 0.5
    for k in ("E_best", "E_hyps", "hyp_probs", "soft_scores", "inlier_weights", "exp_loss",
              "top_loss"):
        ref = np.asarray(want[k])
        np.testing.assert_allclose(got[k].detach().numpy(), ref, rtol=1e-9,
                                   atol=1e-9 * max(np.abs(ref).max(), 1e-30), err_msg=k)
    _leaves_close({"x1": a.grad.numpy()}, {"x1": np.asarray(gj)}, 1e-6)


def test_dsac_draws_from_the_generator(dsac_case):
    x1, x2, _, _ = dsac_case
    a = dsac_essential(torch.from_numpy(x1), torch.from_numpy(x2),
                       generator=torch.Generator().manual_seed(5))
    b = dsac_essential(torch.from_numpy(x1), torch.from_numpy(x2),
                       idx=torch.randint(0, 100, (64, 10), generator=torch.Generator().manual_seed(5)))
    assert torch.equal(a["E_best"], b["E_best"]) and a["E_hyps"].shape == (64, 3, 3)
