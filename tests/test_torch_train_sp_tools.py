"""Port parity: the SuperPoint training tools.

- `tools/train_sp_full.py` and `tools/finetune_sp_corners.py` for 2
  iterations at batch 2 (every stage), both packages from the committed
  checkpoints (experiments/sp_full/sp_joint_11000.msgpack and, with
  `--gauss2`, experiments/g2_corners/sp_corners_gauss2.msgpack): the same
  `metrics.jsonl` records; the first step's loss (before any update:
  `--resume` gives the JAX package's first-step loss) within 1e-5
  relative, later losses within 1e-3 relative (float32 Adam steps), the
  evaluations' match counts within 1 a pair and ratios within 0.02.
- The `.pth.tar` that the port's train_sp_full writes loads into the JAX
  package (`convert_superpoint_state`) and gives the port net's `semi` and
  `desc` in float64 (1e-9).
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.frontend.superpoint import SuperPointNet as JSuperPointNet
from deepfepe_tpu.utils.torch_import import convert_superpoint_state
from deepfepe_tpu_torch.tools import finetune_sp_corners, train_sp_full
from deepfepe_tpu_torch.utils.weights import load_superpoint, superpoint_state_from_file

from _torch_joint_setup import superpoint_float64
from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SP = REPO / "experiments" / "sp_full" / "sp_joint_11000.msgpack"
G2 = REPO / "experiments" / "g2_corners" / "sp_corners_gauss2.msgpack"


def _run_jax_tool(name, argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    mod.main()


def _records(path):
    return [json.loads(line) for line in open(path)]


@pytest.fixture(scope="module")
def tool_runs(tmp_path_factory):
    """Both packages' tools, 2 iterations of every stage at batch 2, from the
    committed checkpoints; {(package, tool): output directory}."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        full = ["--det_iters", "2", "--joint_iters", "2", "--batch", "2", "--pool", "4",
                "--ha_iters", "2", "--ha_images", "2", "--ha_homographies", "2",
                "--resume", str(SP)]
        fine = ["--sp", str(G2), "--gauss2", "--iters", "2", "--batch", "2",
                "--image", "64", "96", "--eval_corners", "30"]
        for tool, argv, port in (("train_sp_full", full, train_sp_full),
                                 ("finetune_sp_corners", fine, finetune_sp_corners)):
            for pkg in ("jax", "port"):
                d = tmp_path_factory.mktemp(f"{pkg}_{tool}")
                if pkg == "jax":
                    _run_jax_tool(tool, [*argv, "--out", str(d)], mp)
                else:
                    out[("summary", tool)] = port.main([*argv, "--out", str(d), "--device", "cpu"])
                out[(pkg, tool)] = d
    finally:
        mp.undo()
    return out


def _assert_same_records(got, want, first_loss_rel=1e-5):
    assert [r["stage"] for r in got] == [r["stage"] for r in want]
    first = True
    for g, w in zip(got, want):
        keys = set(w) - {"elapsed_s", "ckpt", "path"}
        assert keys <= set(g), (w["stage"], keys - set(g))
        for k in sorted(keys):
            if k in ("stage", "iter", "images"):
                assert g[k] == w[k], (w["stage"], k)
            elif k in ("loss", "det", "desc", "det_ce"):
                rel = first_loss_rel if first else 1e-3
                assert abs(g[k] - w[k]) <= rel * abs(w[k]) + 1e-5, (w["stage"], w.get("iter"), k,
                                                                    g[k], w[k])
            elif k == "num_matches":
                assert abs(g[k] - w[k]) <= 1.0, (w["stage"], k, g[k], w[k])
            else:  # ratio@t
                assert abs(g[k] - w[k]) <= 0.02, (w["stage"], k, g[k], w[k])
        first = first and w["stage"] not in ("det", "train")


def test_train_sp_full_matches_the_jax_tool(tool_runs):
    want = _records(tool_runs[("jax", "train_sp_full")] / "metrics.jsonl")
    got = _records(tool_runs[("port", "train_sp_full")] / "metrics.jsonl")
    assert [r["stage"] for r in want] == ["det", "det", "joint", "joint", "ha_labels",
                                           "ha_finetune", "ha_finetune", "final_eval"]
    _assert_same_records(got, want)
    s = tool_runs[("summary", "train_sp_full")]
    assert set(s["stages"]) == {"det", "joint", "ha_labels", "ha_finetune", "final_eval"}
    assert s["final_eval"]["num_matches"] > 5
    names = {p.name for p in tool_runs[("port", "train_sp_full")].iterdir()}
    assert {"sp_det_final.pth.tar", "sp_joint_final.pth.tar", "sp_final.pth.tar"} <= names


def test_finetune_sp_corners_matches_the_jax_tool(tool_runs):
    want = _records(tool_runs[("jax", "finetune_sp_corners")] / "metrics.jsonl")
    got = _records(tool_runs[("port", "finetune_sp_corners")] / "metrics.jsonl")
    assert [r["stage"] for r in want] == ["eval_before", "train", "train", "saved",
                                           "eval_after"]
    _assert_same_records(got, want)
    assert got[3]["path"].endswith("sp_corners_gauss2.pth.tar")
    # BatchNorm ran on the loaded running statistics and left them there.
    saved = superpoint_state_from_file(got[3]["path"])
    loaded = superpoint_state_from_file(str(G2))
    for k in loaded:
        if "running" in k:
            assert torch.equal(saved[k], loaded[k]), k


def test_train_sp_full_checkpoint_loads_into_jax(tool_runs):
    path = tool_runs[("port", "train_sp_full")] / "sp_final.pth.tar"
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt) == {"n_iter", "model_state_dict", "optimizer_state_dict", "loss"}
    assert ckpt["n_iter"] == 6
    net = load_superpoint(str(path), "cpu").double()
    variables = convert_superpoint_state({k: v.numpy() for k, v in
                                          ckpt["model_state_dict"].items()})
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
    x = np.random.RandomState(0).rand(2, 48, 64, 1)
    with superpoint_float64():
        want = JSuperPointNet(dtype=jnp.float64).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for k in ("semi", "desc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-9, atol=1e-9)
