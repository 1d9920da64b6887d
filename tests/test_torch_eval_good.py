"""Port parity for the whole slice: `eval_good` on the DeepFNet solver.

Both packages get the same synthetic batches (B=2, N=200), the same
parameters (carried with `deepfnet_state_from_flax`) and the same RANSAC
hypotheses (the JAX CLI's key chain, PRNGKey(0) split once per batch,
recomputed here and handed to the port as indices). The JAX side runs its
`cmd_eval` pieces: `make_eval_step` and then `val_rt_batch`.

- float64 throughout: the solver's and the ground truth's per-pair errors
  agree to 1e-6 deg.
- float32 (the path's type): they agree to 0.05 deg plus 1% of the error
  (acos near 0 has a float32 floor of about 0.03 deg; a random-weight
  solver far from the truth is sensitive to rounding in its recurrence).
- The RANSAC baseline is held to its inlier count, within 5% of N, and to
  its health bar, in both types. A draw with a repeated index gives a
  minimal set of rank 7, whose null space is a plane: any vector in it is
  a valid fit, the two packages pick different ones, and such a
  hypothesis can win. In float32 the 8-point Gram is also ill-conditioned
  (see tests/test_torch_ransac.py).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.data.synthetic import SyntheticPairs as JSyntheticPairs
from deepfepe_tpu.eval.val_rt import val_rt_batch as j_val_rt_batch
from deepfepe_tpu.models.deepfnet import DeepFNet as JDeepFNet
from deepfepe_tpu.train.config import config_from_dict as j_config_from_dict
from deepfepe_tpu.train.config import load_config as j_load_config
from deepfepe_tpu.train.engine import make_eval_step
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.data import SyntheticPairs
from deepfepe_tpu_torch.models import DeepFNet
from deepfepe_tpu_torch.train.config import config_from_dict, load_config
from deepfepe_tpu_torch.utils.weights import deepfnet_state_from_flax

CONFIG = str(Path(__file__).resolve().parents[1] / "configs" / "synthetic_baseline.yaml")
B, N, H, DEPTH = 2, 200, 512, 3


def _cfg():
    raw = {"data": {"batch_size": B, "good_num": N},
           "model": {"depth": DEPTH, "clamp_at": 0.02, "if_quality": True}}
    return j_config_from_dict(raw), config_from_dict(raw)


def _draws(n_batches):
    key, out = jax.random.PRNGKey(0), []
    for _ in range(n_batches):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, B)
        out.append((sub, torch.from_numpy(np.stack(
            [np.asarray(jax.random.randint(k, (H, 8), 0, N)) for k in keys]))))
    return out


def _params(jnet, batch, seed=2):
    """Parameters of the JAX net's shapes from numpy (cheaper than running
    flax's init eagerly): LeCun-normal kernels, non-trivial biases and
    norm affines."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), batch)

    def fill(path, s):
        name = getattr(path[-1], "key", "")
        if name == "kernel":
            return jnp.asarray(rng.randn(*s.shape) / np.sqrt(s.shape[0]), s.dtype)
        if name == "scale":
            return jnp.asarray(rng.uniform(0.5, 1.5, s.shape), s.dtype)
        return jnp.asarray(rng.uniform(-0.2, 0.2, s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _run_both(dtype):
    jcfg, tcfg = _cfg()
    gen = JSyntheticPairs(image_size=(376, 1241), good_num=N, seed=11)
    batches = [gen.batch(B) for _ in range(2)]
    if dtype == "float64":
        batches = [{k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in b.items()}
                   for b in batches]
    jnet = JDeepFNet(depth=DEPTH, image_size=(376, 1241), if_quality=True,
                     mlp_dtype=getattr(jnp, dtype))
    params = _params(jnet, {k: jnp.asarray(v) for k, v in batches[0].items()})
    step = make_eval_step(jnet, jcfg)
    val_rt = jax.jit(lambda m, jb, key: j_val_rt_batch(
        m["E_ests"], jb["Ks"], jb["matches_xy_ori"], jb["E_gts"], jb["delta_Rtijs_4_4"],
        ransac_key=key))
    draws = _draws(len(batches))
    ref = {k: [] for k in cli.PER_PAIR}
    for batch, (sub, _) in zip(batches, draws):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        rt = val_rt(step(params, jb), jb, sub)
        for k in ref:
            ref[k].append(np.asarray(rt[k]))
    ref = {k: np.concatenate(v) for k, v in ref.items()}

    tnet = DeepFNet(depth=DEPTH, image_size=(376, 1241), if_quality=True,
                    mlp_dtype=getattr(torch, dtype))
    tnet.load_state_dict(deepfnet_state_from_flax(params), strict=True)
    got = cli.evaluate(tcfg, tnet, batches, torch.device("cpu"),
                       ransac_idxs=[idx for _, idx in draws])
    return ref, got


@pytest.mark.parametrize("dtype,atol,rtol", [("float64", 1e-6, 0.0), ("float32", 5e-2, 1e-2)])
def test_eval_good_slice_matches_jax(dtype, atol, rtol):
    ref, got = _run_both(dtype)
    for k in ("err_q_est", "err_t_est", "err_q_gt", "err_t_gt"):
        np.testing.assert_allclose(got[k], ref[k], atol=atol, rtol=rtol, err_msg=k)
    assert np.abs(got["base_inliers"] - ref["base_inliers"]).max() <= 0.05 * N
    assert np.median(got["err_q_base"]) < 0.5 and np.median(ref["err_q_base"]) < 0.5
    assert got["loss_F"].shape == (2,)


def test_synthetic_pairs_match_jax():
    """A numpy copy of the generator: the same seed gives the same pairs.
    The virtual points come from each package's own correction (float32,
    Newton iterations rounded differently: 2e-3 px)."""
    a = JSyntheticPairs(image_size=(376, 1241), good_num=120, seed=4).batch(3)
    b = SyntheticPairs(image_size=(376, 1241), good_num=120, seed=4).batch(3)
    assert a.keys() == b.keys()
    for k in a:
        tol = 2e-3 if k.endswith("_virt") else 0
        np.testing.assert_allclose(b[k], a[k], atol=tol, rtol=0, err_msg=k)
        assert b[k].dtype == a[k].dtype, k


def test_config_copy_matches_jax():
    jc, tc = j_load_config(CONFIG), load_config(CONFIG)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.model.mlp_dtype == "bfloat16" and tc.data.batch_size == 8


def test_cli_eval_good_on_cpu(capsys, tmp_path, monkeypatch):
    import json

    monkeypatch.chdir(tmp_path)  # eval_good writes logs/<exper_name>/
    out = cli.main(["eval_good", CONFIG, "cpu_run", "--max_batches", "1", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("median_err_q", "median_err_t", "median_err_q_base", "median_err_t_base",
              "median_err_q_gt", "pairs"):
        assert k in printed and np.isfinite(printed[k]), k
    assert printed["pairs"] == 8 and printed["device"] == "cpu" and out == printed
    assert printed["median_err_q_gt"] < 1e-3 and printed["median_err_q_base"] < 0.5
    for name in ("DeepF_err_ratio.npz", "ransac_8p_err_ratio.npz"):
        assert len(np.load(tmp_path / "logs" / "cpu_run" / name)["err_q"]) == 8
