"""Port parity: the homography half of `eval/frontend_eval.py` and
`val_feature --homography`.

- `warp_keypoints`, `compute_repeatability`, `homography_correctness`,
  `average_precision` and `matching_score_and_map` against the JAX
  package's on the same numpy inputs: 1e-9 (equal counts).
- `evaluate_homography_pair` with the repo's trained SuperPoint
  (experiments/sp_full/sp_joint_11000.msgpack, read by each package's
  own reader) on the val_feature pairs, the JAX side warping with cv2:
  equal keypoint and match counts and correctness flags, the other metrics
  within 1e-4 (float32 frontends: localization to 1e-3 px).
- `val_feature --homography 1` on the CPU against the JAX CLI's: the same
  `h_*` keys and values within the same bars.
The training tools' parity is in tests/test_torch_train_sp_tools.py.
"""

import argparse
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deepfepe_tpu import cli as jcli
from deepfepe_tpu.eval import frontend_eval as jfe
from deepfepe_tpu.frontend import FrontendParams as JFrontendParams
from deepfepe_tpu.frontend.superpoint import SuperPointNet as JSuperPointNet
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.eval import frontend_eval as tfe
from deepfepe_tpu_torch.frontend import FrontendParams
from deepfepe_tpu_torch.utils.weights import load_superpoint

from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SP = REPO / "experiments" / "sp_full" / "sp_joint_11000.msgpack"
FP = dict(out_num_points=300, conf_thresh=1e-3)  # the JAX CLI's val_feature knobs
COUNTS = ("count1", "count2", "num_matches", "correct@1.0", "correct@3.0", "correct@5.0")


def _jax_params(path, shape=(1, 120, 160, 1)):
    from flax import serialization

    params = jax.eval_shape(JSuperPointNet().init, jax.random.PRNGKey(0), jnp.zeros(shape))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), params)
    with open(path, "rb") as f:
        return serialization.from_bytes(params, f.read())


def _assert_same_metrics(got, want, what=""):
    assert set(got) == set(want), what
    for k in want:
        if k in COUNTS:
            assert got[k] == want[k], (what, k, got[k], want[k])
        else:
            tol = 1e-3 if k == "localization_error" else 1e-4
            assert abs(got[k] - want[k]) <= tol, (what, k, got[k], want[k])


def test_homography_metric_functions_match_jax(rng):
    Hs = cli.homography_pairs(3)
    for _, H in Hs:
        k1 = rng.rand(80, 2) * [160, 120]
        k2 = jfe.warp_keypoints(k1, H)[:60] + rng.randn(60, 2)
        k2 = np.concatenate([k2, rng.rand(25, 2) * [160, 120]])
        np.testing.assert_allclose(tfe.warp_keypoints(k1, H), jfe.warp_keypoints(k1, H),
                                   rtol=0, atol=1e-9)
        want = jfe.compute_repeatability(k1, k2, H, (120, 160))
        got = tfe.compute_repeatability(k1, k2, H, (120, 160))
        assert got.keys() == want.keys() and got["count1"] == want["count1"]
        np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], atol=1e-9)
        m = np.concatenate([k1[:60], k2[:60]], -1)
        for n in (60, 3):
            want = jfe.homography_correctness(m[:n], H, (120, 160))
            got = tfe.homography_correctness(m[:n], H, (120, 160))
            assert got.keys() == want.keys()
            np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want],
                                       atol=1e-9)
        labels = rng.rand(50) < 0.4
        scores = np.round(rng.rand(50), 1)  # ties: the stable order
        assert tfe.average_precision(labels, scores) == pytest.approx(
            jfe.average_precision(labels, scores), abs=1e-12)
        assert tfe.average_precision(labels * 0, scores) == 0.0
        d1 = rng.randn(80, 32)
        d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
        d2 = rng.randn(85, 32)
        d2[:60] = d1[:60] + 0.2 * d2[:60]
        d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
        pad = lambda a, n: np.concatenate([a, np.zeros((n - len(a),) + a.shape[1:])])  # noqa
        v1, v2 = np.arange(90) < 80, np.arange(90) < 85
        args = (pad(k1, 90), pad(d1, 90), v1, pad(k2, 90), pad(d2, 90), v2, H, (120, 160))
        want = jfe.matching_score_and_map(*args)
        got = tfe.matching_score_and_map(*args)
        assert got["num_matches"] == want["num_matches"] > 20
        np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], atol=1e-9)


def test_evaluate_homography_pair_matches_jax():
    params = _jax_params(SP)
    net = load_superpoint(str(SP), "cpu")
    for img, H in cli.homography_pairs(2):
        want = jfe.evaluate_homography_pair(JSuperPointNet(), params, img, H,
                                            JFrontendParams(**FP))
        got = tfe.evaluate_homography_pair(net, img, H, FrontendParams(**FP))
        assert got["num_matches"] > 10
        _assert_same_metrics(got, want)


def test_val_feature_homography_matches_the_jax_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    want = jcli.cmd_val_feature(argparse.Namespace(
        exper_name="j", config="", pretrained=str(SP), max_batches=1, rand_noise=0.0,
        homography=1))
    got = cli.val_feature("t", max_batches=1, pretrained=str(SP), homography=1, device="cpu")
    hkeys = {k for k in want if k.startswith("h_")}
    assert hkeys and hkeys == {k for k in got if k.startswith("h_")}
    _assert_same_metrics({k[2:]: got[k] for k in hkeys}, {k[2:]: want[k] for k in hkeys})
    saved = np.load(tmp_path / "logs" / "t" / "result_dict_all.npz")
    assert hkeys <= set(saved.files)


def test_evaluate_homography_pair_matches_once(monkeypatch):
    """One mutual-NN match a pair serves both the matching score and the
    correctness (one K4 launch a pair on the card at K >= 768)."""
    calls = []
    match = tfe._match
    monkeypatch.setattr(tfe, "_match", lambda *a, **k: calls.append(a[-1]) or match(*a, **k))
    net = load_superpoint(str(SP), "cpu")
    (img, H), = cli.homography_pairs(1)
    out = tfe.evaluate_homography_pair(net, img, H, FrontendParams(**FP))
    assert calls == [1.2] and out["num_matches"] > 10
