"""Port parity: the SIFT-dump workflow tool (`deepfepe_tpu_torch/tools/
dump_workflow.py` against the JAX package's `tools/dump_workflow.py`).

Both tools run at 96x128 with four frames a train scene, ten test frames,
20 corners a texture and one training step (plus one qt step in the
port's run, its second stage), each in its own working directory:

- the same config (the port's JSON against the JAX tool's YAML, but for
  the dump root), and the same summary keys;
- the same dump trees: file names, the frames' JPEG bytes, `cam`, `poses`
  and `Rt_cam2_gt` bit for bit, each frame's SIFT keypoints and
  descriptors at `frontend.sift.PARITY_BARS` and 97% of each pair's match
  rows shared (`test_torch_dump_kitti._same_sift_tree`);
- every stage ran: the checkpoints exist, eval_good scored the nine test
  pairs with a finite median, both VO runs chained the nine pairs.

The two packages' solvers start from different seeded weights, so the
errors are not compared. The JAX tool's commands run with the tests'
parameter templates and jitted `val_rt_batch` (`_jax_cli_fast`); its
compiles make this file take about two minutes on the CPU.
"""

import importlib.util
import json
import math
import sys
from pathlib import Path

import pytest
import yaml

from deepfepe_tpu_torch.tools import dump_workflow as t_tool

from _jax_cli_fast import patch_jax_cli
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_dump_kitti import _same_sift_tree

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--out", "dw", "--train_frames", "12", "--test_frames", "10", "--train_iter", "1",
        "--image", "96", "128", "--n_corners", "20", "--cpu"]


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_dump_workflow",
                                                  REPO / "tools" / "dump_workflow.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("jax"))
        patch_jax_cli(mp)
        mp.setattr(sys, "argv", ["dump_workflow.py", *ARGS])
        _jax_tool().main()
        out["jax"] = Path.cwd()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("torch"))
        t_tool.main([*ARGS, "--qt_iter", "1"])
        out["torch"] = Path.cwd()
    return out


def test_same_config_and_summary_keys(runs):
    j, t = runs["jax"] / "dw", runs["torch"] / "dw"
    jcfg = yaml.safe_load((j / "config.yaml").read_text())
    tcfg = json.loads((t / "config.json").read_text())
    for cfg in (jcfg, tcfg):
        cfg["data"].pop("dump_root")
    assert tcfg == jcfg
    qt = json.loads((t / "config_qt.json").read_text())
    assert qt["model"]["if_qt_loss"] and qt["training"]["train_iter"] == 1
    js, ts = (json.loads((d / "summary.json").read_text()) for d in (j, t))
    assert set(ts) == set(js) | {"ckpt_qt"}
    for k in ("eval_good", "vo_net", "vo_base"):
        assert set(js[k]) <= set(ts[k]), k


def test_same_dump_trees(runs):
    for scene in ("00", "01", "02", "09"):
        files = _same_sift_tree(runs["jax"] / "dw" / "dump" / scene,
                                runs["torch"] / "dw" / "dump" / scene)
        assert "ij_match_quality_0-1_good.npy" in files


def test_every_stage_ran(runs):
    t = runs["torch"]
    s = json.loads((t / "dw" / "summary.json").read_text())
    assert (t / s["ckpt"]).exists() and (t / s["ckpt_qt"]).exists()
    assert s["ckpt_qt"].endswith("deepFNet_2_checkpoint.pth.tar")
    assert s["eval_good"]["pairs"] == 9 and math.isfinite(s["eval_good"]["median_err_q"])
    assert s["eval_good"]["median_err_q_gt"] == 0.0
    for k in ("vo_net", "vo_base"):
        assert s[k]["n_pairs"] == 9 and math.isfinite(s[k]["trans_err_pct"]), k
        assert (t / "logs" / f"dump_workflow_{k}" / "result.txt").exists()
