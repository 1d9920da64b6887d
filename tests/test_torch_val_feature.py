"""Port parity: the `val_feature` slice (synthetic image pairs -> SuperPoint
-> keypoints -> mutual-NN matches -> epipolar distances under gt F).

- `SyntheticImagePairs` batches equal the JAX package's: images, poses, K
  and F exactly (the same numpy code and seed); the virtual points within
  1e-4 px (float32 Newton steps in another framework).
- `frontend_epidist_eval` on the same batches and weights as the JAX one
  (SuperPointNet from the flax init, and gauss2 with the running
  statistics of tests/test_torch_frontend.py): equal match counts,
  ratios within 1 / num_matches (one match on either side of a threshold),
  and each pair's sorted epipolar distances within 1e-3 px.
- `val_feature` on the CPU, 2 batches from a `.pth.tar` written in the
  reference layout: the summary is the JAX `frontend_epidist_eval`'s
  means over the same batches, within the same bars, and
  logs/<exper_name>/result_dict_all.npz holds it. A gauss2 checkpoint
  (BatchNorm keys) builds the gauss2 net.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepfepe_tpu.data.synthetic_images import SyntheticImagePairs as JSyntheticImagePairs
from deepfepe_tpu.eval.frontend_eval import frontend_epidist_eval as jepidist
from deepfepe_tpu.frontend import FrontendParams as JFrontendParams
from deepfepe_tpu.frontend.superpoint import (SuperPointNet as JSuperPointNet,
                                              SuperPointNetGauss2 as JSuperPointNetGauss2)
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.data import SyntheticImagePairs
from deepfepe_tpu_torch.eval import frontend_epidist_eval
from deepfepe_tpu_torch.frontend import FrontendParams, SuperPointNet, SuperPointNetGauss2
from deepfepe_tpu_torch.utils.weights import load_superpoint, superpoint_state_from_flax

from test_torch_frontend import flax_variables

FP = dict(out_num_points=300, conf_thresh=1e-3)  # the JAX CLI's val_feature knobs


def test_synthetic_image_pairs_equal_jax():
    got = SyntheticImagePairs(seed=3).batch(2)
    want = JSyntheticImagePairs(seed=3).batch(2)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k.endswith("_virt"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_batches(n, batch_size=2):
    gen = JSyntheticImagePairs(seed=0)
    return [gen.batch(batch_size) for _ in range(n)]


def _assert_same_eval(got, want):
    nm = np.asarray(want["num_matches"])
    np.testing.assert_array_equal(got["num_matches"], nm)
    for k in (k for k in want if k.startswith("ratio")):
        assert np.all(np.abs(got[k] - np.asarray(want[k])) <= 1.0 / np.maximum(nm, 1)), k
    # Matches come sorted by descriptor distance, which rounds differently in
    # the two packages, so near-equal matches may trade places: compare each
    # pair's distances as a sorted list.
    for g, w in zip(got["epi_dists"], np.asarray(want["epi_dists"])):
        np.testing.assert_allclose(np.sort(g[~np.isnan(g)]), np.sort(w[~np.isnan(w)]), atol=1e-3)


@pytest.mark.parametrize("variant", ["plain", "gauss2"])
def test_frontend_epidist_eval_matches_jax(variant):
    jcls = JSuperPointNet if variant == "plain" else JSuperPointNetGauss2
    jnet = jcls()
    v = flax_variables(jnet, (1, 120, 160, 1))
    net = (SuperPointNetGauss2() if variant == "gauss2" else SuperPointNet()).eval()
    net.load_state_dict(superpoint_state_from_flax(v), strict=True)
    batch = _jax_batches(1)[0]
    imgs, F = batch["imgs_grey"], batch["F_gts"]
    want = jepidist(jnet, v, (jnp.asarray(imgs[:, 0]), jnp.asarray(imgs[:, 1])),
                    jnp.asarray(F), JFrontendParams(**FP))
    t = torch.from_numpy(imgs)
    got = frontend_epidist_eval(net, (t[:, 0], t[:, 1]), torch.from_numpy(F), FrontendParams(**FP))
    assert np.asarray(want["num_matches"]).min() > 20
    _assert_same_eval(got, want)


def test_val_feature_on_the_cpu_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jnet = JSuperPointNet()
    v = flax_variables(jnet, (1, 120, 160, 1))
    ckpt = tmp_path / "sp.pth.tar"
    torch.save({"n_iter": 0, "model_state_dict": superpoint_state_from_flax(v)}, ckpt)
    summary = cli.val_feature("vf", max_batches=2, pretrained=str(ckpt), device="cpu")
    assert summary["pairs"] == 4 and summary["device"] == "cpu"
    outs = [jepidist(jnet, v, (jnp.asarray(b["imgs_grey"][:, 0]), jnp.asarray(b["imgs_grey"][:, 1])),
                     jnp.asarray(b["F_gts"]), JFrontendParams(**FP)) for b in _jax_batches(2)]
    nm = np.mean([np.mean(np.asarray(o["num_matches"])) for o in outs])
    assert summary["num_matches"] == pytest.approx(nm, abs=0)
    for k in ("ratio@0.1", "ratio@0.5", "ratio@1.0", "ratio@2.0"):
        want = np.mean([np.mean(np.asarray(o[k])) for o in outs])
        assert abs(summary[k] - want) <= 1.0 / min(np.min(np.asarray(o["num_matches"]))
                                                   for o in outs), k
    saved = np.load(tmp_path / "logs" / "vf" / "result_dict_all.npz")
    assert {k: float(saved[k]) for k in saved.files} == {
        k: summary[k] for k in summary if k.startswith("ratio") or k == "num_matches"}


def test_val_feature_builds_gauss2_from_batchnorm_keys(tmp_path):
    v = flax_variables(JSuperPointNetGauss2(), (1, 16, 16, 1))
    ckpt = tmp_path / "sp.pth"
    torch.save(superpoint_state_from_flax(v), ckpt)
    assert isinstance(load_superpoint(str(ckpt)), SuperPointNetGauss2)


def test_val_feature_refuses_what_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for kw, what in ((dict(homography=2), "cv2"), (dict(pretrained="sp.msgpack"), "flax")):
        with pytest.raises(NotImplementedError, match=what):
            cli.val_feature("x", device="cpu", **kw)
