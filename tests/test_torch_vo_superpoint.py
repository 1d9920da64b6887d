"""Port parity: SuperPoint VO, `tools/vo_superpoint.py`.

Both packages' tools on one batch of a 9-frame sequence (8 pairs) at
120x160 with 60 corner stamps a plane (N = 200), from the committed
SuperPoint (experiments/sp_full/sp_joint_11000) and solver
(experiments/joint_fullres_train_qt3), without and with `--refine_ba`.
Both solvers run a float32 weight MLP (the tools build a bf16 one, whose
products XLA and PyTorch round at other places) and the port replays the
JAX tool's RANSAC draws (PRNGKey(5) split once a batch). The JAX run's
parameter templates come from `jax.eval_shape` (the checkpoints overwrite
every leaf) and its eager calls run under `jax.jit`, with the same numbers.

Bars, set from a measured run: `n_pairs`, `traj_len` and
`mean_num_matches` equal (the float32 SuperPoint gives both the same
matches); the solver's median err_q within 0.05 deg + 1%
(tests/test_torch_eval_good.py) without the polish (measured 0.023 at
0.80). The 8-point fits of some pairs are near-degenerate on SuperPoint's
few matches (tests/test_torch_joint_tools.py: up to 0.087 apart in
unit-norm E on the same matches), so median err_t and the polished
medians are held to 0.5 deg + 10% (measured 0.09 deg), and the chained
trajectory metrics to 10% + 0.01 (measured 3.9%), with the polish 30% +
0.01 (measured 22%, on RPE_deg: the polish stops at its first rejected
step and carries the solver's rounding on, ROADMAP Queue 3); the RANSAC
baseline's report is held finite (its float32 minimal fits pick other
winners on the same draws, tests/test_torch_vo.py).
The written files: trajectory_{est,base,gt}.txt and summary.json with the
JAX tool's keys.
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

from _jax_cli_fast import jitted_val_rt
from deepfepe_tpu import eval as j_eval
from deepfepe_tpu import frontend as j_frontend
from deepfepe_tpu import models as j_models
from deepfepe_tpu.models import DeepFNet as JDeepFNet
from deepfepe_tpu_torch.tools import sp_pipeline, vo_superpoint
from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SP = REPO / "experiments" / "sp_full" / "sp_joint_11000.msgpack"
DEEPF = REPO / "experiments" / "joint_fullres_train_qt3" / "deepF_stage2_end_to_end.msgpack"
ARGS = ["--sp", str(SP), "--deepf", str(DEEPF), "--n_frames", "9", "--n_corners", "60"]
H = 512
METRICS = ("trans_err_pct", "rot_err_deg_per_100m", "ATE_m", "RPE_m", "RPE_deg")


def _patch_jax(mp, calls):
    import flax.linen as nn

    def template(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda *a: nn.Module.init(self, rngs, *a, **kw), *args)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    for cls in (JDeepFNet, j_frontend.SuperPointNet):
        mp.setattr(cls, "init", template)
    mp.setattr(j_models, "DeepFNet", lambda **kw: JDeepFNet(**{**kw, "mlp_dtype": jnp.float32}))
    real_matches = j_frontend.get_matches_from_sp
    mp.setattr(j_frontend, "get_matches_from_sp", lambda net, p, imgs, fp: jax.jit(
        lambda q, a, b: real_matches(net, q, (a, b), fp))(p, *imgs))
    jitted = jitted_val_rt()

    def recording(E, Ks, m, Eg, D, ransac_key=None, **kw):
        calls.append({"key": ransac_key, "B": E.shape[0], "N": m.shape[1]})
        return jitted(E, Ks, m, Eg, D, ransac_key=ransac_key, **kw)

    mp.setattr(j_eval, "val_rt_batch", recording)


def _patch_port(mp, calls):
    real_config, real_val_rt = sp_pipeline.solver_config, sp_pipeline.val_rt_batch

    def f32_config(*a, **k):
        cfg = real_config(*a, **k)
        cfg.model.mlp_dtype = "float32"
        return cfg

    draws = []
    for c in calls:
        keys = jax.random.split(c["key"], c["B"])
        draws.append(torch.from_numpy(np.stack(
            [np.asarray(jax.random.randint(k, (H, 8), 0, c["N"])) for k in keys])))
    it = iter(draws)
    mp.setattr(vo_superpoint, "solver_config", f32_config)
    mp.setattr(sp_pipeline, "val_rt_batch",
               lambda *a, generator=None, **k: real_val_rt(*a, ransac_idxs=next(it), **k))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    spec = importlib.util.spec_from_file_location("jax_vo_superpoint",
                                                  REPO / "tools" / "vo_superpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = {}
    for tag, extra in (("plain", []), ("refine", ["--refine_ba"])):
        with pytest.MonkeyPatch.context() as mp:
            calls = []
            _patch_jax(mp, calls)
            jdir, pdir = tmp_path_factory.mktemp(f"jax_{tag}"), tmp_path_factory.mktemp(tag)
            mp.setattr(sys, "argv", ["vo_superpoint", *ARGS, *extra, "--out", str(jdir)])
            mod.main()
            _patch_port(mp, calls)
            summary = vo_superpoint.main([*ARGS, *extra, "--out", str(pdir), "--cpu"])
        out[tag] = {"jax": json.loads((jdir / "summary.json").read_text()), "port": summary,
                    "dir": pdir}
    return out


@pytest.mark.parametrize("tag", ["plain", "refine"])
def test_vo_superpoint_matches_the_jax_tool(runs, tag):
    want, got = runs[tag]["jax"], runs[tag]["port"]
    assert set(got) - {"seconds"} == set(want)
    for k in ("n_pairs", "traj_len", "mean_num_matches"):
        assert got[k] == want[k], k
    assert want["n_pairs"] == 8
    assert set(got["est"]) == set(want["est"]) == set(got["base"])
    for k, w in want["est"].items():
        g = got["est"][k]
        if k == "median_err_q" and tag == "plain":
            assert abs(g - w) <= 0.05 + 0.01 * abs(w), (k, g, w)
        elif k.startswith("median"):
            assert abs(g - w) <= 0.5 + 0.1 * abs(w), (k, g, w)
        else:
            rel = 0.1 if tag == "plain" else 0.3
            assert abs(g - w) <= 0.01 + rel * abs(w), (k, g, w)
    assert all(np.isfinite(v) for v in got["base"].values())


def test_vo_superpoint_files(runs):
    d = runs["plain"]["dir"]
    assert json.loads((d / "summary.json").read_text()) == {
        k: v for k, v in runs["plain"]["port"].items() if k != "seconds"}
    for name in ("est", "base", "gt"):
        rows = np.loadtxt(d / f"trajectory_{name}.txt")
        assert rows.shape == (9, 12) and np.isfinite(rows).all()
