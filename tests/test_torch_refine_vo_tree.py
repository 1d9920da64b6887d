"""Port parity for the BA surface of the CLI over dump trees, against the
JAX CLI: `eval_vo --pose_graph` and `eval_good --refine_ba` on a synthetic
tree with delta-2 match files (`write_corr_dump(deltas=(1, 2))`, one scene
of 10 frames: 9 + 8 pairs), the flagship solver with a float32 MLP, N =
200. As in tests/test_torch_refine_vo.py, the port's CLI runs once with
its own solver (reports finite, the fused rot the chained one's) and once
on the JAX solver's outputs, held to the JAX CLI's reports, fused
trajectory and npz rows at that file's replay bars. A tree without
delta-2 files stops both CLIs with the same message. The JAX CLI is made
cheaper as there (`patch_jax`).
"""

import numpy as np
import pytest

from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.data.synthetic_dump import write_corr_dump
from deepfepe_tpu_torch.train import load_config
from test_torch_refine_vo import (CKPT, MIN_MATCHES, PG_ROT_TOL, REPLAY_POSE_ATOL, VO_KEYS,
                                  _yaml, assert_eval_good_close, assert_vo_close,
                                  jax_eval_good, jax_eval_vo, patch_jax, replay_solver)
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tree_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("refine_vo_tree")
    tree = root / "tree"
    write_corr_dump(tree, scenes=1, frames=10, matches=240, seed=6, deltas=(1, 2))
    on_tree = _yaml(root, "tree", dataset="kitti_odo_corr", dump_root=str(tree))
    short = root / "short"
    write_corr_dump(short, scenes=1, frames=5, matches=240, seed=1)
    no_skip = _yaml(root, "short", dataset="kitti_odo_corr", dump_root=str(short))
    out = {"jax": {}, "port": {}, "replay": {}, "root": root}
    solver = []
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        patch_jax(mp, [], solver)
        out["jax"]["vo"] = jax_eval_vo(on_tree, "j_tree", scene="00", lengths="1,2",
                                       pose_graph=True)
        out["jax"]["eval_good"] = jax_eval_good(on_tree, "j_eg_tree", max_batches=0)
        with pytest.raises(SystemExit, match="needs delta-2 pairs") as e:
            jax_eval_vo(no_skip, "j_short", scene="00", pose_graph=True)
        out["jax"]["exit"] = str(e.value)
        vo = ["--pretrained", CKPT, "--scene", "00", "--lengths", "1,2", "--pose_graph",
              "--device", "cpu"]
        eval_good = ["--pretrained", CKPT, "--max_batches", "0", "--refine_ba",
                     "--refine_min_matches", str(MIN_MATCHES), "--device", "cpu"]
        out["port"]["vo"] = cli.main(["eval_vo", on_tree, "p_tree", *vo])
        out["port"]["eval_good"] = cli.main(["eval_good", on_tree, "p_eg_tree", *eval_good])
        with pytest.raises(SystemExit, match="needs delta-2 pairs") as e:
            cli.eval_vo(load_config(no_skip), "p_short", pretrained=CKPT, scene="00",
                        pose_graph=True, device="cpu")
        out["port"]["exit"] = str(e.value)
        assert len(solver) == 6  # eval_vo 2 + 1 batches, eval_good 2, the short tree's 1
        replay_solver(mp, solver[:5])
        out["replay"]["vo"] = cli.main(["eval_vo", on_tree, "r_tree", *vo])
        out["replay"]["eval_good"] = cli.main(["eval_good", on_tree, "r_eg_tree", *eval_good])
    return out


def test_eval_vo_pose_graph_on_a_delta2_dump_tree_matches_jax(tree_runs):
    got, want, own = (tree_runs[k]["vo"] for k in ("replay", "jax", "port"))
    assert got["n_pairs"] == want["n_pairs"] == own["n_pairs"] == 9
    assert_vo_close(got, want)
    assert_vo_close(got["pose_graph"], want["pose_graph"])
    a = np.loadtxt(tree_runs["root"] / "logs" / "r_tree" / "trajectory_pose_graph.txt")
    b = np.loadtxt(tree_runs["root"] / "logs" / "j_tree" / "trajectory_pose_graph.txt")
    assert a.shape == b.shape == (10, 12)
    np.testing.assert_allclose(a, b, atol=REPLAY_POSE_ATOL)
    for rep in (got, want, own):
        assert abs(rep["pose_graph"]["rot_err_deg_per_100m"] - rep["rot_err_deg_per_100m"]) \
            <= PG_ROT_TOL
        assert all(np.isfinite(rep["pose_graph"][k]) for k in VO_KEYS)


def test_eval_good_refine_on_a_dump_tree_matches_jax(tree_runs):
    """The dump-tree path of eval_good --refine_ba: the whole split (9
    pairs, the tail padded and trimmed) polished and dumped."""
    assert_eval_good_close(tree_runs["replay"]["eval_good"], tree_runs["jax"]["eval_good"],
                           tree_runs["port"]["eval_good"], tree_runs["root"], 9)


def test_pose_graph_needs_delta2_files_in_both_clis(tree_runs):
    assert tree_runs["port"]["exit"] == tree_runs["jax"]["exit"]
