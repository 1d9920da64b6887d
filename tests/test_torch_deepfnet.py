"""Port parity: the weight MLP and the DeepFNet forward with carried weights.

The JAX package's parameters go across through `deepfnet_state_from_flax`
(and through the JAX package's own `export_deepf_state`, loaded with
strict=True). Inputs are made with numpy from a seed.

- float64 MLP and geometry: F_est, each layer's F and weights agree to
  1e-6 relative; this is the algorithm's parity.
- bfloat16 MLP (the config default): XLA and PyTorch round the bf16
  products and sums at other places, each worth up to 2^-8 = 0.4% of a
  logit, and the recurrence feeds them forward through the softmax.
  Measured over depth 3: 3.0e-2 on the unit-norm F_est entries, and 2.8e-3
  (8% of the largest weight) on a few of the 600 weights; the bars are
  5e-2 and 15% of the largest weight.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.data.synthetic import SyntheticPairs
from deepfepe_tpu.models.deepfnet import DeepFNet as JDeepFNet
from deepfepe_tpu.models.error_estimator import ErrorEstimator as JErrorEstimator
from deepfepe_tpu.utils.torch_import import export_deepf_state
from deepfepe_tpu_torch.models import DeepFNet, ErrorEstimator
from deepfepe_tpu_torch.train.config import config_from_dict
from deepfepe_tpu_torch.loader import model_loader
from deepfepe_tpu_torch.utils.weights import (
    deepfnet_state_from_flax,
    error_estimator_state_from_flax,
)
from _torch_threads import one_torch_thread  # noqa: F401

SIZE = (376, 1241)


def _randomize(params, seed=0):
    """Non-trivial norm affines and biases, so no layer is identity-covered."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "scale":
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
        if names[-1] == "bias":
            return jnp.asarray(rng.uniform(-0.2, 0.2, x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(f, params)


@pytest.fixture(scope="module")
def batch():
    b = SyntheticPairs(image_size=SIZE, good_num=100, seed=3).batch(2)
    return {"matches_xy_ori": b["matches_xy_ori"].astype(np.float64),
            "quality": b["quality"]}


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-9), ("bfloat16", 3e-2)])
def test_error_estimator_matches_jax(rng, dtype, rtol):
    x = rng.rand(2, 50, 5)
    jnet = JErrorEstimator(output_size=1, dtype=getattr(jnp, dtype))
    params = _randomize(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    yj = np.asarray(jnet.apply(params, jnp.asarray(x)))
    tnet = ErrorEstimator(5, 1, dtype=getattr(torch, dtype))
    tnet.load_state_dict(error_estimator_state_from_flax(params["params"], ""), strict=True)
    with torch.no_grad():
        yt = tnet(torch.from_numpy(x)).double().numpy()
    np.testing.assert_allclose(yt, yj, rtol=rtol, atol=rtol * np.abs(yj).max())


def _jax_forward(batch, mlp_dtype, depth=3):
    net = JDeepFNet(depth=depth, image_size=SIZE, if_quality=True, mlp_dtype=mlp_dtype,
                    sign_canonical=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _randomize(jax.jit(net.init)(jax.random.PRNGKey(1), jb), seed=1)
    return params, jax.jit(net.apply)(params, jb)


def _port_forward(batch, state, mlp_dtype, depth=3):
    net = DeepFNet(depth=depth, image_size=SIZE, if_quality=True, mlp_dtype=mlp_dtype,
                   sign_canonical=True)
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        return net({k: torch.from_numpy(v) for k, v in batch.items()})


def _unit(F):
    F = np.asarray(F, np.float64)
    return F / np.linalg.norm(F, axis=(-1, -2), keepdims=True)


def test_deepfnet_forward_f64_matches_jax(batch):
    params, oj = _jax_forward(batch, jnp.float64)
    ot = _port_forward(batch, deepfnet_state_from_flax(params), torch.float64)
    np.testing.assert_allclose(_unit(ot["F_est"]), _unit(oj["F_est"]), atol=1e-6)
    np.testing.assert_allclose(_unit(ot["out_layers"]), _unit(oj["out_layers"]), atol=1e-6)
    for k in ("weights_layers", "logits_layers", "epi_res_layers"):
        ref = np.asarray(oj[k])
        np.testing.assert_allclose(ot[k].numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=k)
    scale = np.abs(np.asarray(oj["residual_layers"])).max()
    np.testing.assert_allclose(ot["residual_layers"].numpy(), np.asarray(oj["residual_layers"]),
                               atol=1e-6 * scale)
    for k in ("T1", "T2", "pts1", "pts2"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=1e-12, err_msg=k)


def test_deepfnet_forward_bf16_matches_jax(batch):
    params, oj = _jax_forward(batch, jnp.bfloat16)
    ot = _port_forward(batch, deepfnet_state_from_flax(params), torch.bfloat16)
    np.testing.assert_allclose(_unit(ot["F_est"]), _unit(oj["F_est"]), atol=5e-2)
    ref = np.asarray(oj["weights_layers"])
    np.testing.assert_allclose(ot["weights_layers"].numpy(), ref, rtol=0,
                               atol=0.15 * ref.max())


def test_export_deepf_state_loads_strict_with_same_logits(batch):
    params, _ = _jax_forward(batch, jnp.float64, depth=2)
    a = _port_forward(batch, deepfnet_state_from_flax(params), torch.float64, depth=2)
    exported = {k: torch.from_numpy(np.asarray(v)) for k, v in export_deepf_state(params).items()}
    assert any(v.dim() == 3 for v in exported.values())  # Conv1d [out, in, 1] layout
    b = _port_forward(batch, exported, torch.float64, depth=2)
    for k in ("logits_layers", "F_est"):
        assert torch.equal(a[k], b[k]), k


def test_model_loader_rejects_the_unported_mlp_kernel():
    # The MLP kernel is ported now: use_pallas_mlp routes both weight MLPs
    # to it; if_des (ported too, the reference's if_img_des_to_pointnet)
    # builds 261- and 264-wide inputs, which the routing keeps off it
    # (tests/test_torch_weightnet_variants.py runs that forward).
    cfg = config_from_dict({"model": {"use_pallas_mlp": True}})
    net = model_loader(cfg, torch.device("cpu"))
    assert net.input_weights.use_fused and net.update_weights.use_fused
    assert not model_loader(config_from_dict({}), torch.device("cpu")).input_weights.use_fused
    des = model_loader(config_from_dict({"model": {"if_img_des_to_pointnet": True,
                                                   "if_quality": True, "use_pallas_mlp": True}}),
                       torch.device("cpu"))
    assert des.if_des and des.input_weights.fw[0].in_features == 261
    assert des.update_weights.fw[0].in_features == 264


def test_seeded_parameters_are_reproducible():
    cfg = config_from_dict({"model": {"if_quality": True}})
    a = model_loader(cfg, torch.device("cpu"), torch.Generator().manual_seed(5))
    b = model_loader(cfg, torch.device("cpu"), torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.input_weights.fw[6].weight  # the 128 -> 1024 layer
    assert abs(float(w.detach().std()) - (1 / 128) ** 0.5) < 0.01
