"""Port parity: the single-sample qualitative pipeline
(`eval/val_pipeline.py`, `ValPipelineFrontend` and `load_params_msgpack`)
against the JAX package's, with the weights carried across as `.msgpack`
files.

- `load_params_msgpack` reads both layouts, a TrainState (the flagship
  checkpoint) and bare parameters written by flax, into the same state.
- Precomputed-match mode (synthetic pairs, the flagship solver) and
  SuperPoint mode (synthetic image pairs, a seeded gauss2 frontend with
  randomized running statistics, the flagship solver): the JAX pipeline's
  RANSAC draws are replayed into the port's (`ransac_idxs`). The match
  counts equal and the match sets within 2e-3 px; the pixel-frame F̂ (unit
  norm, sign fixed) within 2e-4 (2e-3 in SuperPoint mode, where matches of
  near-equal distance swap places, and so do the repeated matches that
  pad the set: 4e-4 seen); err_q/err_t of est and gt within 0.05 deg plus
  1% (the float32 bar of tests/test_torch_eval_good.py: acos near 0 has a
  float32 floor of about 0.03 deg; 0.011 deg seen); the inlier ratios of
  est and gt within one match (3% in SuperPoint mode, the padding's order:
  1.2% seen); the baseline's ratios within 5% of N and its health (median
  err_q under 0.5 deg in both), as tests/test_torch_eval_good.py holds it
  (degenerate draws let the packages' RANSAC pick different fits); in
  SuperPoint mode, where an untrained frontend leaves the baseline
  unhealthy, its errors within the est bar.
- `plot_one_sample` writes the three figures (matplotlib, Agg).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import matplotlib

matplotlib.use("Agg")

import flax.linen as nn  # noqa: E402

from deepfepe_tpu import eval as j_eval  # noqa: E402
from deepfepe_tpu.data import SyntheticPairs  # noqa: E402
from deepfepe_tpu.data.synthetic_images import SyntheticImagePairs  # noqa: E402
from deepfepe_tpu.eval import val_pipeline as j_vp  # noqa: E402
from deepfepe_tpu.frontend import FrontendParams as JFrontendParams  # noqa: E402
from deepfepe_tpu.frontend.superpoint import SuperPointNetGauss2 as JGauss2  # noqa: E402
from deepfepe_tpu.models import DeepFNet as JDeepFNet  # noqa: E402
from deepfepe_tpu_torch.eval import ValPipelineFrontend, load_params_msgpack  # noqa: E402
from deepfepe_tpu_torch.frontend import FrontendParams, SuperPointNetGauss2  # noqa: E402
from deepfepe_tpu_torch.models import DeepFNet  # noqa: E402
from deepfepe_tpu_torch.train import load_checkpoint  # noqa: E402

from test_torch_frontend import flax_variables  # noqa: E402
from test_torch_infer import CKPT  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401

HYPS = 512


def jax_draws(B, n, seed=0):
    """The RANSAC draws of the JAX pipeline's default key."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return torch.from_numpy(np.stack([np.asarray(jax.random.randint(k, (HYPS, 8), 0, n))
                                      for k in keys]))


@pytest.fixture(scope="module", autouse=True)
def fast_jax():
    """The DeepFNet's flax init from eval_shape (every leaf is restored
    from a file after) and the pose validation jitted: the same numbers,
    compiled once. SuperPoint keeps its init: the tests draw their
    weights from it."""
    def template(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda *a: nn.Module.init(self, rngs, *a, **kw), *args)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JDeepFNet, "init", template)
        mp.setattr(j_vp, "val_rt_batch", jax.jit(j_eval.val_rt_batch,
                                                 static_argnames=("ransac_hypotheses",
                                                                  "ransac_threshold_px",
                                                                  "five_point")))
        yield


def _bare(tmp_path, params, name):
    path = tmp_path / name
    path.write_bytes(serialization.to_bytes(jax.tree_util.tree_map(np.asarray, params)))
    return str(path)


def _unit(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F, axis=(-1, -2), keepdims=True)
    flat = F.reshape(F.shape[0], 9)
    return F * np.sign(flat[np.arange(len(flat)), np.abs(flat).argmax(-1)])[:, None, None]


def _compare(got, want, n_matches, f_bar=2e-4, ratio_bar=None, base_health=True):
    n = want["batch"]["matches_good_unique_nums"]
    np.testing.assert_array_equal(got["batch"]["matches_good_unique_nums"], n)
    for b in range(len(n)):  # the same matches; near-equal distances may swap places
        rows = [np.round(r["batch"]["matches_xy_ori"][b, :n[b]], 3) for r in (got, want)]
        a, c = (r[np.lexsort(r.T[::-1])] for r in rows)
        np.testing.assert_allclose(a, c, atol=2e-3)
    np.testing.assert_allclose(_unit(got["preds"]["F_est_pix"]),
                               _unit(want["preds"]["F_est_pix"]), atol=f_bar)
    for k in ("err_q_est", "err_t_est", "err_q_gt", "err_t_gt"):
        np.testing.assert_allclose(got["val"][k], want["val"][k], atol=5e-2, rtol=1e-2, err_msg=k)
    for r in (got, want):
        assert np.median(r["val"]["err_q_base"]) < 0.5 or not base_health
    if not base_health:
        for k in ("err_q_base", "err_t_base"):
            np.testing.assert_allclose(got["val"][k], want["val"][k], atol=5e-2, rtol=1e-2)
    for name in ("est", "gt", "base"):
        for k, v in want["ratios"][name].items():
            bar = 0.05 if name == "base" else ratio_bar or 1.0 / n_matches + 1e-6
            np.testing.assert_allclose(got["ratios"][name][k], v, atol=bar, err_msg=f"{name} {k}")


def test_load_params_msgpack_reads_both_layouts(tmp_path):
    from deepfepe_tpu_torch.utils import msgpack_io

    net_a, net_b, net_c = (DeepFNet(depth=5, if_quality=True) for _ in range(3))
    load_params_msgpack(CKPT, net_a)  # a TrainState
    bare = tmp_path / "bare.msgpack"
    tree = msgpack_io.load_params_msgpack(CKPT)["params"]
    bare.write_bytes(serialization.to_bytes(tree))
    load_params_msgpack(str(bare), net_b)  # bare parameters
    load_checkpoint(CKPT, net_c)
    for k, t in net_a.state_dict().items():
        assert torch.equal(t, net_b.state_dict()[k]) and torch.equal(t, net_c.state_dict()[k]), k
    with pytest.raises(ValueError, match="no layout"):
        load_params_msgpack(CKPT, SuperPointNetGauss2())


def test_precomputed_matches_mode_matches_jax(tmp_path):
    batch = SyntheticPairs(good_num=128, seed=3).batch(2)
    jnet = JDeepFNet(depth=5, if_quality=True)
    want = j_vp.ValPipelineFrontend(jnet, CKPT, batch).eval_one_sample(batch)
    vp = ValPipelineFrontend(DeepFNet(depth=5, if_quality=True), CKPT, batch)
    got = vp.eval_one_sample(batch, ransac_idxs=jax_draws(2, 128))
    _compare(got, want, 128)
    assert float(np.median(got["val"]["err_q_gt"])) < 0.1
    figs = vp.plot_one_sample(got, save_dir=str(tmp_path / "plots"))
    assert set(figs) == {"corr", "epipolar", "weights"}
    for name in figs:
        assert (tmp_path / "plots" / f"{name}_0.png").exists()


def test_superpoint_mode_matches_jax(tmp_path):
    size = (120, 160)
    batch = SyntheticImagePairs(image_size=size, seed=5).batch(2)
    v = flax_variables(JGauss2(dtype=jnp.float32), (1, *size, 1))
    sp_ckpt = _bare(tmp_path, v, "sp.msgpack")
    kw = dict(out_num_points=128, conf_thresh=1e-4, nn_thresh=1.2)
    jvp = j_vp.ValPipelineFrontend(JDeepFNet(depth=5, image_size=size, if_quality=True), CKPT,
                                   batch, sp_net=JGauss2(dtype=jnp.float32),
                                   sp_params_path=sp_ckpt, fp=JFrontendParams(**kw))
    want = jvp.eval_one_sample(batch)
    vp = ValPipelineFrontend(DeepFNet(depth=5, image_size=size, if_quality=True), CKPT, batch,
                             sp_net=SuperPointNetGauss2(), sp_params_path=sp_ckpt,
                             fp=FrontendParams(**kw))
    got = vp.eval_one_sample(batch, ransac_idxs=jax_draws(2, 128))
    assert (got["batch"]["matches_good_unique_nums"] >= 8).all()
    _compare(got, want, 128, f_bar=2e-3, ratio_bar=0.03, base_health=False)
    with pytest.raises(ValueError, match="sp_params_path"):
        ValPipelineFrontend(DeepFNet(depth=5, if_quality=True), CKPT, sp_net=SuperPointNetGauss2())
