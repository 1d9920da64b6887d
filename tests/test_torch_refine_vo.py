"""Port parity for the two-view polish (`eval/refine.py`) and the CLI's BA
surface (`eval_vo --refine_ba --pose_graph`, `eval_good --refine_ba`,
`eval_vo --pose_graph` on a dump tree), against the JAX package.

- `refine_two_view_batch` on the same pairs, weights and initial poses
  (float32, as the CLIs run it): refined R within 1e-5 and unit t within
  1e-4 of the JAX function's (measured 6e-8 and 2e-6), the same pairs
  accepted (a pair whose acceptance differs must be a near tie: its two
  robust costs within 1e-4 relative), the costs within 1e-4 relative
  (float32 sums of a few hundred Huber terms: 1.2e-5 measured).
- The CLIs at a small size: the flagship solver with a float32 MLP, N =
  200, a 10-frame sequence (9 + 8 pairs), `--refine_min_matches 100`
  (N = 200 leaves too few pairs at the default 200). Every polish call of
  the JAX CLI, fed to the port's function, gives the JAX CLI's refined
  poses (the bars above): the CLI wiring is the same.
- The reports: the two solvers' float32 outputs differ by rounding (E
  within 2e-3, held in tests/test_torch_vo.py), and the polish carries
  such a difference on wherever a Gauss-Newton step is rejected (it stops
  there), up to degrees of a pair's translation. So the port's CLI runs
  twice: with its own solver, whose reports are held to their kind (finite,
  the fused rot the chained one's within 0.02 deg/100 m, the fused trans
  lower than the chained), and replaying the JAX solver's outputs batch
  after batch (`replay_solver`), held to the JAX CLI's: the trajectories
  within 1e-4 (measured 3e-6), the VO metrics within 0.1% + 0.005 (acos of
  a near-identity rotation turns those 3e-6 into 0.0015 deg of RPE), the
  dumped camera poses within 1e-4, the median and per-pair errors within
  0.1 deg: a polished pair's error is mostly below float32's acos floor,
  where a trace a few ulps from 3 reads 0, 0.028, 0.040 or 0.056 deg
  (measured: 0 against 0.056).
- `tools/vo_pose_graph.py` at a small size on the CPU.
(The dump-tree paths: tests/test_torch_refine_vo_tree.py.)

The JAX CLI runs cheaper without changing a number it is compared on
(`patch_jax`): parameter templates from `jax.eval_shape`, one compiled eval
step for its runs (the same net and shapes), `val_rt_batch` and the
pose-graph step jitted, and `eval_good` without its RANSAC baseline, whose
rows these tests do not compare.
"""

import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from _jax_cli_fast import jitted_val_rt, patch_jax_cli
from conftest import synthetic_pair
from deepfepe_tpu import cli as j_cli
from deepfepe_tpu.ba import pose_graph as jpg
from deepfepe_tpu.eval import refine as j_refine
from deepfepe_tpu.train import loop as j_loop
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.eval.refine import refine_two_view_batch
from deepfepe_tpu_torch.train import load_config
from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = REPO / "experiments" / "flagship"
CKPT = str(FLAGSHIP / "ckpt_qt_best.msgpack")
N, FRAMES, MIN_MATCHES = 200, 10, 100
R_BAR, T_BAR, COST_RTOL, TIE_REL = 1e-5, 1e-4, 1e-3, 1e-4
REPLAY_RTOL, REPLAY_ATOL, REPLAY_ERR_ATOL, REPLAY_POSE_ATOL = 1e-3, 5e-3, 0.1, 1e-4
PG_ROT_TOL = 0.02
VO_KEYS = ("trans_err_pct", "rot_err_deg_per_100m", "ATE_m", "RPE_m", "RPE_deg")


def _pairs(rng, B=6, n=300, noise=0.8):
    """Synthetic pairs with solver-quality initial poses (1.5 deg and 0.08
    off) and inlier-ish weights, float32."""
    ms, ws, Ks, Rs, ts = [], [], [], [], []
    for _ in range(B):
        d = synthetic_pair(rng, n=n, noise=noise, outlier_frac=0.15)
        ms.append(np.concatenate([d["x1"], d["x2"]], -1))
        ws.append(rng.rand(n))
        Ks.append(d["K"])
        ax = rng.randn(3)
        ax /= np.linalg.norm(ax)
        a = np.deg2rad(1.5)
        Kx = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
        Rs.append((np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * Kx @ Kx) @ d["R"])
        tp = d["t"] + 0.08 * rng.randn(3)
        ts.append(tp / np.linalg.norm(tp))
    return [np.stack(x).astype(np.float32) for x in (ms, ws, Ks, Rs, ts)]


def _assert_refines_alike(got, want):
    """(R, t, info) of the port against the JAX function's."""
    (R, t, info), (jR, jt, jinfo) = got, want
    acc, jacc = info["accepted"].numpy(), np.asarray(jinfo["accepted"])
    flips = acc != jacc
    for name, i in (("port", info), ("jax", jinfo)):
        before, after = np.asarray(i["cost_before"]), np.asarray(i["cost_after"])
        assert np.all(np.abs(after - before)[flips] <= TIE_REL * before[flips]), (name, flips)
    same = ~flips
    np.testing.assert_allclose(R.numpy()[same], np.asarray(jR)[same], atol=R_BAR, rtol=0)
    np.testing.assert_allclose(t.numpy()[same], np.asarray(jt)[same], atol=T_BAR, rtol=0)
    for k in ("cost_before", "cost_after", "final_rms_px")[:len(jinfo) - 1]:
        np.testing.assert_allclose(info[k].numpy()[same], np.asarray(jinfo[k])[same],
                                   rtol=COST_RTOL, atol=1e-6, err_msg=k)
    if "n_eff" in jinfo:
        np.testing.assert_array_equal(info["n_eff"].numpy(), np.asarray(jinfo["n_eff"]))


@pytest.mark.parametrize("kw", [
    dict(iters=5, min_matches=200),
    dict(iters=4, huber_px=2.0, refine_rotation=False, weight_floor=0.1),
    dict(iters=3, damping=1e-2, min_matches=0)])
def test_refine_two_view_batch_matches_jax(kw, rng):
    args = _pairs(rng)
    got = refine_two_view_batch(*[torch.from_numpy(a) for a in args], **kw)
    want = jax.jit(lambda *a: j_refine.refine_two_view_batch(*a, **kw))(
        *[jnp.asarray(a) for a in args])
    _assert_refines_alike(got, want)
    assert got[0].dtype == torch.float32
    if not kw.get("refine_rotation", True):
        np.testing.assert_array_equal(got[0].numpy(), args[3])


def test_refine_acceptance_guard(rng):
    """tests/test_ba.py's guard case on the port: 140 noisy matches whose
    initial pose is the ground truth keep it exactly under min_matches 200;
    with 50 the polish engages and never raises its robust cost."""
    ms, Ks, Rs, ts = [], [], [], []
    for _ in range(2):
        d = synthetic_pair(rng, n=140, noise=2.0)
        ms.append(np.concatenate([d["x1"], d["x2"]], -1))
        Ks.append(d["K"])
        Rs.append(d["R"])
        ts.append(d["t"] / np.linalg.norm(d["t"]))
    args = [torch.from_numpy(np.stack(x)) for x in (ms, np.ones((2, 140)), Ks, Rs, ts)]
    R, t, info = refine_two_view_batch(*args, iters=6, min_matches=200)
    assert not info["accepted"].any()
    np.testing.assert_array_equal(R.numpy(), np.stack(Rs))
    np.testing.assert_allclose(t.numpy(), np.stack(ts), atol=1e-15)
    R2, _, info2 = refine_two_view_batch(*args, iters=6, min_matches=50)
    assert info2["accepted"].all() and (info2["cost_after"] <= info2["cost_before"]).all()
    assert np.abs(R2.numpy() - np.stack(Rs)).max() > 1e-9
    want = j_refine.refine_two_view_batch(*[jnp.asarray(a.numpy()) for a in args], iters=6,
                                          min_matches=50)
    _assert_refines_alike((R2, _, info2), want)


# --- the CLIs ------------------------------------------------------------------


def _yaml(root: Path, name: str, **data) -> str:
    raw = yaml.safe_load((FLAGSHIP / "vo_net" / "config.yml").read_text())
    raw["data"]["good_num"] = N
    raw["data"].update(data)
    raw["model"]["mlp_dtype"] = "float32"
    path = root / f"{name}.yml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def est_only_val_rt(jitted):
    """The JAX `val_rt_batch` without its RANSAC baseline (most of a JAX
    eval_good run's compile), the estimate's outputs standing in for the
    baseline's keys: these tests compare the solver's rows only."""
    def val_rt(E, Ks, m, Eg, D, ransac_key=None, five_point=False):
        out = dict(jitted(E, Ks, m, Eg, D, ransac_key=None, five_point=five_point))
        for k in ("err_q", "err_t", "M_cam", "M", "epi_dists"):
            out[f"{k}_base"] = out[f"{k}_est"]
        return out
    return val_rt


def patch_jax(mp, calls: list, solver: list) -> None:
    """The JAX CLI made cheaper (`_jax_cli_fast`, one compiled eval step for
    every run, the pose-graph step jitted, eval_good without its RANSAC
    baseline), with every polish call recorded in `calls` and every solver
    output (E_ests, weights, loss_F) in `solver`."""
    patch_jax_cli(mp, est_only_val_rt(jitted_val_rt()))
    made = []
    real_make = j_loop.make_eval_step

    def make_eval_step(net, cfg):
        if not made:
            step = real_make(net, cfg)

            def recording_step(params, batch):
                m = step(params, batch)
                solver.append({k: np.asarray(m[k]) for k in ("E_ests", "weights", "loss_F")})
                return m

            made.append(recording_step)
        return made[0]

    real_refine = j_refine.refine_two_view_batch

    def recording(m, w, K, R, t, **kw):
        out = real_refine(m, w, K, R, t, **kw)
        jax.debug.callback(lambda *a: calls.append([np.asarray(x) for x in a]), m, w, K, R, t,
                           out[0], out[1], out[2]["accepted"], out[2]["cost_before"],
                           out[2]["cost_after"])
        return out

    mp.setattr(j_loop, "make_eval_step", make_eval_step)
    mp.setattr(j_refine, "refine_two_view_batch", recording)
    mp.setattr(jpg, "gauss_newton_step", jax.jit(
        jpg.gauss_newton_step, static_argnames=("damping", "fix_first", "huber_delta")))


def jax_eval_vo(config, exper_name, **kw):
    args = dict(config=config, exper_name=exper_name, pretrained=CKPT, scene="", n_frames=0,
                lengths="", pose_graph=False, baseline=False, refine_ba=False,
                refine_min_matches=MIN_MATCHES)
    return j_cli.cmd_eval_vo(types.SimpleNamespace(**{**args, **kw}))


def replay_solver(mp, outputs: list) -> None:
    """The port's CLI takes the JAX solver's outputs, batch after batch, in
    place of its own eval step."""
    queue = list(outputs)
    mp.setattr(cli, "eval_step",
               lambda net, tb, cfg: {k: torch.from_numpy(v.copy()) for k, v in queue.pop(0).items()})


def jax_eval_good(config, exper_name, max_batches=1):
    return j_cli.cmd_eval(types.SimpleNamespace(
        config=config, exper_name=exper_name, pretrained=CKPT, max_batches=max_batches,
        refine_ba=True, refine_min_matches=MIN_MATCHES))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs on the same inputs: `eval_vo --refine_ba --pose_graph` on
    the 10-frame sequence and `eval_good --refine_ba` on one synthetic
    batch, the port's CLI once with its own solver and once replaying the
    JAX solver's outputs; with every polish call of the JAX CLI."""
    root = tmp_path_factory.mktemp("refine_vo")
    synth = _yaml(root, "synth")
    calls, solver = [], []
    out = {"jax": {}, "port": {}, "replay": {}, "calls": calls, "root": root}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        patch_jax(mp, calls, solver)
        out["jax"]["vo"] = jax_eval_vo(synth, "j_vo", n_frames=FRAMES, pose_graph=True,
                                       refine_ba=True)
        out["n_vo_calls"], n_vo_solver = len(calls), len(solver)
        out["jax"]["eval_good"] = jax_eval_good(synth, "j_eg")
        vo = dict(pretrained=CKPT, n_frames=FRAMES, pose_graph=True, refine_ba=True,
                  refine_min_matches=MIN_MATCHES, device="cpu")
        eval_good = ["--pretrained", CKPT, "--max_batches", "1", "--refine_ba",
                     "--refine_min_matches", str(MIN_MATCHES), "--device", "cpu"]
        out["port"]["vo"] = cli.eval_vo(load_config(synth), "p_vo", **vo)
        out["port"]["eval_good"] = cli.main(["eval_good", synth, "p_eg", *eval_good])
        replay_solver(mp, solver)
        out["replay"]["vo"] = cli.eval_vo(load_config(synth), "r_vo", **vo)
        out["replay"]["eval_good"] = cli.main(["eval_good", synth, "r_eg", *eval_good])
    assert n_vo_solver == 3 and len(solver) == 4
    return out


def test_cli_polish_calls_give_the_jax_clis_poses(runs):
    """Every polish of the JAX CLI (two eval_vo sweeps, one eval_good
    batch), replayed through the port's function with the CLI's settings."""
    calls = runs["calls"]
    assert runs["n_vo_calls"] == 3 and len(calls) == 4  # 2 + 1 batches, then eval_good's
    for m, w, K, R, t, jR, jt, acc, before, after in calls:
        got = refine_two_view_batch(*[torch.from_numpy(a) for a in (m, w, K, R, t)], iters=5,
                                    min_matches=MIN_MATCHES)
        _assert_refines_alike(got, (jR, jt, {"accepted": acc, "cost_before": before,
                                             "cost_after": after}))
        assert acc.any()


def assert_vo_close(got, want, rtol=REPLAY_RTOL, atol=REPLAY_ATOL):
    for k in VO_KEYS:
        assert abs(got[k] - want[k]) <= atol + rtol * abs(want[k]), (k, got[k], want[k])


def test_eval_vo_refine_pose_graph_matches_jax(runs):
    """On the JAX solver's outputs the port's CLI gives the JAX CLI's
    reports and trajectories; with its own solver, reports of the same
    kind: finite, the fused rot the chained one's, the fused trans lower."""
    got, want = runs["replay"]["vo"], runs["jax"]["vo"]
    assert got["n_pairs"] == want["n_pairs"] == FRAMES - 1
    assert_vo_close(got, want)
    assert_vo_close(got["pose_graph"], want["pose_graph"])
    for k in ("median_err_q", "median_err_t"):
        assert abs(got[k] - want[k]) <= REPLAY_ERR_ATOL, (k, got, want)
    root = runs["root"]
    for name in ("trajectory_pose_graph.txt", "trajectory_est.txt", "trajectory_gt.txt"):
        a = np.loadtxt(root / "logs" / "r_vo" / name)
        b = np.loadtxt(root / "logs" / "j_vo" / name)
        assert a.shape == b.shape == (FRAMES, 12)
        np.testing.assert_allclose(a, b, atol=REPLAY_POSE_ATOL, err_msg=name)
    own = runs["port"]["vo"]
    for rep in (got, want, own):
        assert abs(rep["pose_graph"]["rot_err_deg_per_100m"] - rep["rot_err_deg_per_100m"]) \
            <= PG_ROT_TOL
        assert rep["pose_graph"]["trans_err_pct"] < rep["trans_err_pct"]
        assert all(np.isfinite(rep[k]) and np.isfinite(rep["pose_graph"][k]) for k in VO_KEYS)
    assert own["n_pairs"] == FRAMES - 1 and own["skip_seconds"] > 0
    assert own["pose_graph_seconds"] > 0


def assert_eval_good_close(got, want, own, root, pairs):
    """eval_good --refine_ba on the JAX solver's outputs against the JAX
    CLI: the summary's solver medians and the solver's npz rows; the
    port's own run: the same rows, finite."""
    assert got["pairs"] == want["pairs"] == own["pairs"] == pairs
    assert got["median_err_q_gt"] == own["median_err_q_gt"] == 0.0
    for k in ("median_err_q", "median_err_t"):
        assert abs(got[k] - want[k]) <= REPLAY_ERR_ATOL, (k, got, want)
    a = np.load(root / "logs" / got["exper_name"] / "DeepF_err_ratio.npz")
    b = np.load(root / "logs" / f"j{got['exper_name'][1:]}" / "DeepF_err_ratio.npz")
    for k in ("err_q", "err_t"):
        np.testing.assert_allclose(a[k], b[k], atol=REPLAY_ERR_ATOL, rtol=0, err_msg=k)
    # The dumped camera poses are the inverted refined forward poses.
    assert a["relative_poses_cam"].shape == b["relative_poses_cam"].shape == (pairs, 3, 4)
    np.testing.assert_allclose(a["relative_poses_cam"], b["relative_poses_cam"],
                               atol=REPLAY_POSE_ATOL)
    c = np.load(root / "logs" / own["exper_name"] / "DeepF_err_ratio.npz")
    R = c["relative_poses_cam"][:, :, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.tile(np.eye(3), (pairs, 1, 1)),
                               atol=1e-5)
    assert np.isfinite(c["err_q"]).all() and np.isfinite(c["err_t"]).all()


def test_eval_good_refine_matches_jax(runs):
    assert_eval_good_close(runs["replay"]["eval_good"], runs["jax"]["eval_good"],
                           runs["port"]["eval_good"], runs["root"], 8)


def test_vo_pose_graph_tool_runs_small_on_the_cpu(tmp_path):
    from deepfepe_tpu_torch.tools import vo_pose_graph

    out = tmp_path / "vopg"
    summary = vo_pose_graph.main([
        "--sp", str(REPO / "experiments" / "sp_full" / "sp_joint_11000.msgpack"), "--deepf",
        CKPT, "--n_frames", "6", "--image", "120", "160", "--npts", "100", "--batch", "4",
        "--two_stage", "--gn_iters", "3", "--device", "cpu", "--out", str(out)])
    for name in ("chained", "pose_graph"):
        assert set(summary[name]) == set(VO_KEYS)
        assert np.isfinite(summary[name]["ATE_m"]) and np.isfinite(summary[name]["RPE_m"])
    for name in ("chained", "pose_graph", "gt"):
        assert np.loadtxt(out / f"trajectory_{name}.txt").shape == (6, 12)
    assert (out / "summary.json").is_file() and summary["device"] == "cpu"
