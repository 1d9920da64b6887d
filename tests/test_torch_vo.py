"""Port parity for the VO-evaluation slice: the flax checkpoint reader, the
flagship solver, the VO and trajectory metrics, `eval_vo` and the table and
gate tools, against the JAX package.

- The msgpack reader decodes `experiments/flagship/ckpt_qt_best.msgpack`
  leaf for leaf equal, bit for bit, to flax's `msgpack_restore`; bfloat16
  leaves, numpy scalars and chunked arrays too; an ext code flax does not
  write raises.
- VO metrics with no JAX compile: the committed flagship trajectories
  (`experiments/flagship/vo_{net,base}/trajectory_{gt,est}.txt`) through
  the port's `evaluate_sequence(align='scale', lengths=(5, 10, 20, 40))`
  give their `result.txt` within 5e-3 (the bar of
  tests/test_eval_vo.py:63-67; result.txt rounds to 1e-3) and the JAX
  function's numbers within 1e-9 (the same float64 numpy arithmetic).
- The numpy modules (TUM metrics, chaining, snippet ATE, the synthetic
  sequence, the result tables, the io helpers) against their JAX
  counterparts on the same inputs, exactly or within 1e-12.
- `eval_vo` end to end: the JAX CLI's `cmd_eval_vo` and the port's
  `eval_vo` on one batch of the synthetic sequence (n_frames 9: 8 pairs,
  N = 200, the flagship's depth 5, float32 MLP) with the flagship weights,
  the net and the 8-point baseline, the port replaying the JAX CLI's
  RANSAC draws (PRNGKey(0) split once a batch). The JAX run is made
  cheaper without changing a number: its parameter template comes from
  `jax.eval_shape` (the checkpoint overwrites every leaf; the eager init
  costs ~30 s), the baseline run reuses the net run's compiled eval step
  (the same net and config), and `val_rt_batch` runs under `jax.jit`.
  Bars: the solver's per-pair errors within float32's 0.05 deg + 1%
  (tests/test_torch_eval_good.py); the solver's E_ests (unit Frobenius
  norm, sign-aligned) within 2e-3; the chained VO metrics within 5% +
  1e-3: 8 pairs make only 5 m segments, and a segment metric divides the
  packages' per-pair float32 differences (within the bars above) by 5 m
  (measured: 1.5% on trans %, 0.9% on rot, under 0.4% on ATE and RPE).
  The baseline's float32 minimal fits round differently in the two
  packages (tests/test_torch_ransac.py): on the same draws the winners
  differ on most pairs (inlier counts up to 5 of 200 apart), so its
  report is held to its pair count, finiteness and RANSAC health (median
  err_q < 0.5 deg), its inlier counts within 5% of N (the bar of
  tests/test_torch_eval_good.py), and its pose errors to the solver's bars
  on the pairs whose inlier counts agree.
"""

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from _jax_cli_fast import jitted_val_rt, patch_jax_cli
from deepfepe_tpu import cli as j_cli
from deepfepe_tpu.data.synthetic_sequence import SyntheticSequence as JSyntheticSequence
from deepfepe_tpu.eval import kitti_odometry as j_ko
from deepfepe_tpu.eval import results as j_results
from deepfepe_tpu.eval import tum as j_tum
from deepfepe_tpu.eval import vo as j_vo
from deepfepe_tpu.train import loop as j_loop
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.data import SyntheticSequence
from deepfepe_tpu_torch.data.synthetic_dump import write_corr_dump
from deepfepe_tpu_torch.eval import kitti_odometry, results, tum, vo
from deepfepe_tpu_torch.loader import model_loader
from deepfepe_tpu_torch.train import eval_step, load_checkpoint, load_config
from deepfepe_tpu_torch.utils import msgpack_io
from deepfepe_tpu_torch.utils.device import batch_to_device
from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = REPO / "experiments" / "flagship"
CKPT = str(FLAGSHIP / "ckpt_qt_best.msgpack")
N, N_FRAMES, H = 200, 9, 512
VO_KEYS = ("trans_err_pct", "rot_err_deg_per_100m", "ATE_m", "RPE_m", "RPE_deg")
ANGLE_ATOL, ANGLE_RTOL = 5e-2, 1e-2
VO_RTOL, VO_ATOL = 5e-2, 1e-3
E_UNIT_BAR = 2e-3


# --- the msgpack reader -----------------------------------------------------


def _same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif want is None or isinstance(want, (bool, int, float, str, bytes)):
        assert type(got) is type(want) and got == want, path
    elif isinstance(got, torch.Tensor):  # bfloat16
        assert got.dtype == torch.bfloat16 and str(np.asarray(want).dtype) == "bfloat16", path
        assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16)), path
    else:
        w = np.asarray(want)
        assert isinstance(got, (np.ndarray, np.generic)) and got.dtype == w.dtype, path
        assert got.shape == w.shape and got.tobytes() == w.tobytes(), path


def test_msgpack_reader_decodes_the_flagship_as_flax():
    from flax import serialization

    data = Path(CKPT).read_bytes()
    got = msgpack_io.msgpack_restore(data)
    _same_tree(got, serialization.msgpack_restore(data))
    assert got["opt_state"] is None and int(got["n_iter"]) == 600
    leaves = got["params"]["params"]["input_weights"]
    assert leaves["Dense_0"]["kernel"].shape == (5, 64)
    assert msgpack_io.load_params_msgpack(CKPT).keys() == got.keys()


def test_msgpack_reader_decodes_bfloat16_scalars_and_chunks(monkeypatch):
    from flax import serialization

    rng = np.random.RandomState(0)
    tree = {"w": jnp.asarray(rng.randn(3, 5), jnp.bfloat16), "s": np.float32(2.5),
            "i": np.int64(-7), "n": 300, "neg": -3, "big": 2 ** 40, "f": 0.25, "b": True,
            "none": None, "txt": "x" * 40, "raw": b"\x00\x01", "l": [1, 2.0],
            "empty": np.zeros((0, 3), np.float32), "u8": np.arange(300, dtype=np.uint8)}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)  # chunk "u8" and "w"
    data = serialization.to_bytes(tree)
    got = msgpack_io.msgpack_restore(data)
    _same_tree(got, serialization.msgpack_restore(data))
    assert got["w"].dtype == torch.bfloat16 and got["u8"].shape == (300,)


@pytest.mark.parametrize("blob,what", [
    (b"\xd4\x02\x00", "ext type 2"),                 # flax's complex number
    (b"\xc7\x01\x09\x00", "ext type 9"),
    (b"\x92\x01", "ends early"),
    (b"\x01\x02", "bytes after"),
    (b"\xc1", "starts no msgpack value"),
])
def test_msgpack_reader_refuses_what_flax_does_not_write(blob, what):
    with pytest.raises(msgpack_io.MsgpackError, match=what):
        msgpack_io.unpackb(blob)


def test_flagship_loads_strictly_and_a_mismatched_net_refuses_it():
    cfg = load_config(str(FLAGSHIP / "vo_net" / "config.yml"))
    net = model_loader(cfg, torch.device("cpu"))
    assert load_checkpoint(CKPT, net) == 600
    state = msgpack_io.load_params_msgpack(CKPT)["params"]["params"]
    np.testing.assert_array_equal(net.state_dict()["input_weights.fw.0.weight"].numpy(),
                                  state["input_weights"]["Dense_0"]["kernel"].T)
    cfg.model.if_quality = False  # 4 input features against the file's 5
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_checkpoint(CKPT, model_loader(cfg, torch.device("cpu")))


# --- VO metrics against committed results -----------------------------------


def _result_txt(path):
    out = {}
    for line in Path(path).read_text().splitlines():
        key, _, val = line.partition(":")
        try:
            out[key.strip()] = float(val)
        except ValueError:
            pass
    return out


@pytest.mark.parametrize("run", ["vo_net", "vo_base"])
def test_evaluate_sequence_reproduces_the_committed_flagship_results(run):
    d = FLAGSHIP / run
    gt = kitti_odometry.load_poses_txt(str(d / "trajectory_gt.txt"))
    est = kitti_odometry.load_poses_txt(str(d / "trajectory_est.txt"))
    got = kitti_odometry.evaluate_sequence(gt, est, align="scale", lengths=(5, 10, 20, 40))
    want = j_ko.evaluate_sequence(gt, est, align="scale", lengths=(5, 10, 20, 40))
    ref = _result_txt(d / "result.txt")
    names = {"trans_err_pct": "Trans. err. (%)", "rot_err_deg_per_100m": "Rot. err. (deg/100m)",
             "ATE_m": "ATE (m)", "RPE_m": "RPE (m)", "RPE_deg": "RPE (deg)"}
    for k, name in names.items():
        assert abs(got[k] - ref[name]) < 5e-3, (k, got[k], ref[name])
        assert abs(got[k] - want[k]) < 1e-9, (k, got[k], want[k])


# --- the numpy modules against the JAX package ------------------------------


def _random_trajectory(rng, n=25):
    from deepfepe_tpu_torch.data.synthetic import _random_rotation

    poses = [np.eye(4)]
    for _ in range(n - 1):
        T = np.eye(4)
        T[:3, :3] = _random_rotation(rng, 5.0)
        T[:3, 3] = rng.randn(3) * 0.3 + [0, 0, 1.0]
        poses.append(poses[-1] @ T)
    return np.stack(poses)


def _noisy(rng, poses):
    out = poses.copy()
    out[:, :3, 3] += rng.randn(len(poses), 3) * 0.05
    return out


def _write_npz_experiments(root, rng):
    seq = {}
    for name, s in (("a", 1.0), ("b", 2.0), ("c", 0.5)):
        (root / name).mkdir()
        np.savez(root / name / "DeepF_err_ratio.npz", err_q=rng.rand(40) * s,
                 err_t=rng.rand(40) * 3 * s, epi_dists=rng.rand(40, 10) * s,
                 mscores=rng.rand(40, 10))
        seq[name] = [name, "DeepF_err_ratio.npz", 1000]
    return {"data": {"base_path": str(root), "seq_dict": {**seq, "missing": ["z", "x.npz"]}}}


def _case(name, tmp_path):
    """(port result, JAX result) of one numpy function on the same inputs."""
    rng = np.random.RandomState(3)
    gt = _random_trajectory(rng)
    est = _noisy(rng, gt)
    if name == "tum_ate":
        return tum.ate(gt[:, :3, 3], est[:, :3, 3]), j_tum.ate(gt[:, :3, 3], est[:, :3, 3])
    if name.startswith("tum_rpe"):
        kw = {"tum_rpe_frames": {}, "tum_rpe_meters": dict(delta=2.0, delta_unit="m"),
              "tum_rpe_degrees": dict(delta=10.0, delta_unit="deg"),
              "tum_rpe_all_pairs": dict(fixed_delta=False, max_pairs=100, scale=1.5)}[name]
        return tum.rpe(gt, est, **kw), j_tum.rpe(gt, est, **kw)
    if name == "tum_associate":
        a, b = np.sort(rng.rand(30)), np.sort(rng.rand(25))
        return tum.associate(a, b, 0.05, 0.01), j_tum.associate(a, b, 0.05, 0.01)
    if name == "chain_round_trip":
        rel = np.stack([np.linalg.inv(gt[i + 1]) @ gt[i] for i in range(len(gt) - 1)])
        got = vo.chain_relative_poses(rel[:, :3])
        np.testing.assert_allclose(got, gt, atol=1e-9)
        return got, j_vo.chain_relative_poses(rel[:, :3])
    if name == "cam_to_body":
        Rt = _random_trajectory(rng, 2)[1]
        return (vo.relative_pose_cam_to_body(est[:4, :3], Rt),
                j_vo.relative_pose_cam_to_body(est[:4, :3], Rt))
    if name == "pose_seq_ate":
        return vo.pose_seq_ate(est, gt), j_vo.pose_seq_ate(est, gt)
    if name.startswith("align_"):
        mode = name[len("align_"):]
        return (kitti_odometry.align_trajectory(gt, est, mode),
                j_ko.align_trajectory(gt, est, mode))
    if name == "kitti_default_lengths":
        long = _random_trajectory(rng, 400)
        long[:, :3, 3] *= 3.0
        noisy = _noisy(rng, long)
        return (kitti_odometry.evaluate_sequence(long, noisy),
                j_ko.evaluate_sequence(long, noisy))
    if name == "synthetic_sequence":
        kw = dict(n_frames=6, good_num=64, noise_px=0.5, outlier_frac=0.15, seed=123)
        got, want = SyntheticSequence(**kw), JSyntheticSequence(**kw)
        out = [list(got.pair_batches(4)), list(want.pair_batches(4)),
               list(got.pair_batches(4, delta=2)), list(want.pair_batches(4, delta=2))]
        for g, w in ((out[0], out[1]), (out[2], out[3])):
            for bg, bw in zip(g, w):
                assert set(bg) == set(bw)
                for k in bw:
                    tol = 2e-3 if k.endswith("_virt") else 0
                    np.testing.assert_allclose(bg[k], bw[k], atol=tol, rtol=0, err_msg=k)
        return got.gt_trajectory(), want.gt_trajectory()
    if name in ("tables_markdown", "tables_latex", "result_processor"):
        config = _write_npz_experiments(tmp_path, rng)
        got = results.ExpTableProcessor.from_config(config)
        want = j_results.ExpTableProcessor.from_config(config)
        if name == "tables_markdown":
            m = ("err_q_median", "err_t_median", "err_q_mean")
            return (got.to_markdown(m, top_k=2, higher_better=(False, True)),
                    want.to_markdown(m, top_k=2, higher_better=(False, True)))
        if name == "tables_latex":
            return got.to_latex(), want.to_latex()
        rp, jp = got.experiments["b"], want.experiments["b"]
        return ([rp.inlier_ratio(), rp.pose_error_stats(), rp.ratio_curve("err_t"),
                 rp.ap_inlier_thd(mask_thds=(0.0, 0.5))],
                [jp.inlier_ratio(), jp.pose_error_stats(), jp.ratio_curve("err_t"),
                 jp.ap_inlier_thd(mask_thds=(0.0, 0.5))])
    raise KeyError(name)


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, str):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=0, atol=1e-12, err_msg=path)


@pytest.mark.parametrize("name", [
    "tum_ate", "tum_rpe_frames", "tum_rpe_meters", "tum_rpe_degrees", "tum_rpe_all_pairs",
    "tum_associate", "chain_round_trip", "cam_to_body", "pose_seq_ate", "align_scale",
    "align_6dof", "align_7dof", "align_none", "kitti_default_lengths", "synthetic_sequence",
    "tables_markdown", "tables_latex", "result_processor"])
def test_numpy_modules_match_jax(name, tmp_path):
    got, want = _case(name, tmp_path)
    _assert_same(got, want)


def test_io_helpers_match_jax(tmp_path):
    from deepfepe_tpu.utils import io as j_io
    from deepfepe_tpu_torch.utils import io

    obj = {"a": np.arange(6.0).reshape(2, 3), "b": {"c": np.int32(4)}}
    io.savepklz(obj, tmp_path / "x.pklz")
    _assert_same(j_io.loadpklz(tmp_path / "x.pklz"), obj)
    assert io.dict_update({"a": {"b": 1}}, {"a": {"c": 2}}) == j_io.dict_update(
        {"a": {"b": 1}}, {"a": {"c": 2}})
    pytest.importorskip("h5py")
    io.saveh5(obj, str(tmp_path / "x.h5"))
    _assert_same(j_io.loadh5(str(tmp_path / "x.h5")), obj)


# --- eval_vo end to end against the JAX CLI -------------------------------------


def _vo_yaml(root: Path) -> str:
    raw = yaml.safe_load((FLAGSHIP / "vo_net" / "config.yml").read_text())
    raw["data"]["good_num"] = N
    raw["model"]["mlp_dtype"] = "float32"
    path = root / "flagship_small.yml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.fixture(scope="module")
def jax_vo(tmp_path_factory):
    """The JAX CLI's `cmd_eval_vo` with the flagship, net then baseline:
    the reports, the JAX solver's E_ests and val_rt outputs of each batch,
    and the RANSAC keys the baseline drew with."""
    root = tmp_path_factory.mktemp("jax_vo")
    config = _vo_yaml(root)
    calls = []
    jitted = jitted_val_rt()

    def recording(E, Ks, m, Eg, D, ransac_key=None, five_point=False):
        out = jitted(E, Ks, m, Eg, D, ransac_key=ransac_key, five_point=five_point)
        calls.append({"E": np.asarray(E), "key": ransac_key,
                      "rt": {k: np.asarray(v) for k, v in out.items()}})
        return out

    made = []
    real_make = j_loop.make_eval_step

    def make_eval_step(net, cfg):
        if not made:
            made.append(real_make(net, cfg))
        return made[0]

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        patch_jax_cli(mp, recording)
        mp.setattr(j_loop, "make_eval_step", make_eval_step)
        for tag, base in (("net", False), ("base", True)):
            start = len(calls)
            args = types.SimpleNamespace(
                config=config, exper_name=f"j_{tag}", pretrained=CKPT, scene="",
                n_frames=N_FRAMES, lengths="", pose_graph=False, baseline=base,
                refine_ba=False, refine_min_matches=200)
            out[tag] = {"report": j_cli.cmd_eval_vo(args), "calls": calls[start:],
                        "dir": root / "logs" / f"j_{tag}"}
    out["config"] = config
    return out


def _replayed_draws(calls):
    idxs = []
    for c in calls:
        keys = jax.random.split(c["key"], len(c["E"]))
        idxs.append(torch.from_numpy(np.stack(
            [np.asarray(jax.random.randint(k, (H, 8), 0, N)) for k in keys])))
    return idxs


@pytest.fixture(scope="module")
def port_vo(jax_vo, tmp_path_factory):
    """The port's `eval_vo` on the same data, weights and draws: the
    reports and each batch's val_rt outputs."""
    root = tmp_path_factory.mktemp("port_vo")
    calls = []
    real_val_rt = cli.val_rt_batch

    def recording(*a, **k):
        out = real_val_rt(*a, **k)
        calls.append({key: v.numpy() for key, v in out.items()})
        return out

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setattr(cli, "val_rt_batch", recording)
        cfg = load_config(jax_vo["config"])
        for tag, base in (("net", False), ("base", True)):
            start = len(calls)
            idxs = _replayed_draws(jax_vo["base"]["calls"]) if base else None
            out[tag] = {"report": cli.eval_vo(cfg, f"p_{tag}", pretrained=CKPT, baseline=base,
                                              n_frames=N_FRAMES, device="cpu", ransac_idxs=idxs),
                        "dir": root / "logs" / f"p_{tag}", "calls": calls[start:]}
    return out


def _unit(E):
    E = E / np.linalg.norm(E, axis=(-1, -2), keepdims=True)
    flat = E.reshape(len(E), -1)
    sign = np.sign(flat[np.arange(len(E)), np.abs(flat).argmax(-1)])
    return E * sign[:, None, None]


def test_flagship_forward_matches_jax(jax_vo):
    """The port's DeepFNet with the flagship weights on the JAX run's batch:
    E_ests and the per-pair pose errors."""
    cfg = load_config(jax_vo["config"])
    net = model_loader(cfg, torch.device("cpu"))
    load_checkpoint(CKPT, net)
    seq = SyntheticSequence(n_frames=N_FRAMES, good_num=N, noise_px=cfg.data.noise_px,
                            outlier_frac=cfg.data.outlier_frac, seed=123)
    tb = batch_to_device(next(seq.pair_batches(cfg.data.batch_size)), torch.device("cpu"))
    E = eval_step(net, tb, cfg)["E_ests"]
    call = jax_vo["net"]["calls"][0]
    assert np.abs(_unit(E.double().numpy()) - _unit(call["E"].astype(np.float64))).max() \
        < E_UNIT_BAR
    rt = cli.val_rt_batch(E, tb["Ks"], tb["matches_xy_ori"], tb["E_gts"], tb["delta_Rtijs_4_4"],
                          ransac=False)
    for k in ("err_q_est", "err_t_est", "err_q_gt", "err_t_gt"):
        np.testing.assert_allclose(rt[k].numpy(), call["rt"][k], atol=ANGLE_ATOL,
                                   rtol=ANGLE_RTOL, err_msg=k)


def _assert_reports_agree(got, want):
    assert got["n_pairs"] == want["n_pairs"] == N_FRAMES - 1
    for k in VO_KEYS:
        assert abs(got[k] - want[k]) <= VO_ATOL + VO_RTOL * abs(want[k]), (k, got[k], want[k])
    for k in ("median_err_q", "median_err_t"):
        assert abs(got[k] - want[k]) <= ANGLE_ATOL + ANGLE_RTOL * abs(want[k]), (k, got, want)


def test_eval_vo_net_matches_jax(jax_vo, port_vo):
    got, want = port_vo["net"]["report"], jax_vo["net"]["report"]
    _assert_reports_agree(got, want)
    assert got["device"] == "cpu" and got["pairs_per_s"] > 0
    for name in ("trajectory_gt.txt", "trajectory_est.txt"):
        a = np.loadtxt(port_vo["net"]["dir"] / name)
        b = np.loadtxt(jax_vo["net"]["dir"] / name)
        assert a.shape == b.shape == (N_FRAMES, 12)
        np.testing.assert_allclose(a, b, atol=1e-6 if name == "trajectory_gt.txt" else 5e-2)
    lines = [(p.split(":")[0]) for p in
             (port_vo["net"]["dir"] / "result.txt").read_text().splitlines()]
    assert lines == [p.split(":")[0] for p in
                     (jax_vo["net"]["dir"] / "result.txt").read_text().splitlines()]


def test_eval_vo_baseline_matches_jax(jax_vo, port_vo):
    got, want = port_vo["base"]["report"], jax_vo["base"]["report"]
    assert got["n_pairs"] == want["n_pairs"] == N_FRAMES - 1
    assert all(np.isfinite(got[k]) for k in VO_KEYS)
    assert got["median_err_q"] < 0.5 and want["median_err_q"] < 0.5
    # Pair by pair on the same draws: where both packages count the same
    # inliers (the same winning hypothesis, refit on the same set), the
    # baseline's pose errors agree at the solver's bars.
    rt, jrt = port_vo["base"]["calls"][0], jax_vo["base"]["calls"][0]["rt"]
    same = rt["base_inliers"] == jrt["base_inliers"]
    assert same.any() and np.abs(rt["base_inliers"] - jrt["base_inliers"]).max() <= 0.05 * N
    for k in ("err_q_base", "err_t_base"):
        np.testing.assert_allclose(rt[k][same], jrt[k][same], atol=ANGLE_ATOL, rtol=ANGLE_RTOL,
                                   err_msg=k)


# --- the CLI's tools ------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    write_corr_dump(root, scenes=2, frames=6, matches=120, seed=4)
    return root


def _j_args(**kw):
    return types.SimpleNamespace(**kw)


def test_verify_dump_matches_jax(tree, capsys):
    got = cli.main(["verify_dump", str(tree), "--deltas", "1,2"])
    want = j_cli.cmd_verify_dump(_j_args(dump_root=str(tree), deltas="1,2", min_matches=8))
    assert got == want and got["ok"]
    assert json.loads(capsys.readouterr().out.splitlines()[0]) == got


def test_verify_dump_fails_a_broken_tree(tree, tmp_path):
    import shutil

    broken = tmp_path / "broken"
    shutil.copytree(tree, broken)
    scene = sorted(p for p in broken.iterdir() if p.is_dir())[0]
    (scene / "ij_match_quality_2-3_good.npy").unlink()
    (sorted(p for p in broken.iterdir() if p.is_dir())[1] / "Rt_cam2_gt.npy").unlink()
    with pytest.raises(SystemExit):
        cli.verify_dump(str(broken))
    with pytest.raises(SystemExit):
        j_cli.cmd_verify_dump(_j_args(dump_root=str(broken), deltas="1", min_matches=8))
    with pytest.raises(SystemExit, match="no scene"):
        cli.verify_dump(str(tmp_path / "broken" / scene.name))


def _gate_inputs(tree, tmp_path):
    """eval_good's npz dumps of one scene of the tree (as seq '09') and its
    gt trajectory as KITTI text."""
    scene = sorted(p for p in tree.iterdir() if p.is_dir())[0]
    yml = tmp_path / "gate.yaml"
    yml.write_text(yaml.safe_dump({
        "data": {"dataset": "kitti_odo_corr", "dump_root": str(tree), "batch_size": 4,
                 "good_num": 100, "test_scenes": [scene.name],
                 "image": {"size": [376, 1241, 3]}, "preprocessing": {"resize": [376, 1240]}},
        "model": {"depth": 2, "mlp_dtype": "float32"},
        "exps": {"base_name": "ransac_8p", "our_name": "DeepF", "filename": "err_ratio.npz"},
        "training": {"seed": 0}}))
    cli.main(["eval_good", str(yml), "gate09", "--max_batches", "0", "--device", "cpu"])
    poses = np.load(scene / "poses.npy").reshape(-1, 3, 4)
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    np.savetxt(gt_dir / "09.txt", poses.reshape(-1, 12))
    return tmp_path / "logs" / "gate09", gt_dir


def test_baseline_gate_on_eval_good_dumps_matches_jax(tree, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    d, gt_dir = _gate_inputs(tree, tmp_path)
    args = ["baseline_gate", f"09={d}", "--gt_dir", str(gt_dir), "--lengths", "1,2"]
    got = cli.main(args)
    out = capsys.readouterr().out
    want = j_cli.cmd_baseline_gate(_j_args(
        seq_dirs=[f"09={d}"], gt_dir=str(gt_dir), baseline="deepF", exp="DeepF",
        filename="err_ratio.npz", tol=0.05, lengths="1,2", strict=False))
    assert "| seq | metric | ours | baseline | delta | verdict |" in out
    _assert_same(json.loads(json.dumps(got)), json.loads(json.dumps(want)))
    assert set(got["sequences"]["09"]["pass"]) == set(VO_KEYS)


def test_baseline_gate_fails_a_nonfinite_metric(tmp_path, monkeypatch):
    d = tmp_path / "eval"
    d.mkdir()
    np.savez(d / "DeepF_err_ratio.npz", relative_poses_body=np.tile(np.eye(4)[None, :3], (3, 1, 1)))
    gt_dir = tmp_path / "gt"
    gt_dir.mkdir()
    (gt_dir / "09.txt").write_text("\n".join(["1 0 0 0 0 1 0 0 0 0 1 0"] * 4) + "\n")
    bad = {"trans_err_pct": float("nan"), "rot_err_deg_per_100m": 0.1, "ATE_m": 0.1,
           "RPE_m": 0.1, "RPE_deg": 0.1}
    monkeypatch.setattr(kitti_odometry, "evaluate_sequence", lambda *a, **k: dict(bad))
    report = cli.main(["baseline_gate", f"09={d}", "--gt_dir", str(gt_dir)])
    assert report["ok"] is False and report["sequences"]["09"]["pass"]["trans_err_pct"] is False
    json.dumps(report)
    with pytest.raises(SystemExit):
        cli.main(["baseline_gate", f"09={d}", "--gt_dir", str(gt_dir), "--strict"])
    with pytest.raises(SystemExit, match="seq=dir"):
        cli.main(["baseline_gate", str(d), "--gt_dir", str(gt_dir)])


def test_tables_matches_jax(tmp_path, capsys):
    config = _write_npz_experiments(tmp_path, np.random.RandomState(5))
    path = tmp_path / "table.yaml"
    path.write_text(yaml.safe_dump(config))
    got = cli.main(["tables", str(path), "--metrics", "err_q_median,err_t_mean", "--top_k", "2",
                    "--latex"])
    port_out = capsys.readouterr().out
    want = j_cli.cmd_tables(_j_args(config=str(path), metrics="err_q_median,err_t_mean",
                                    top_k=2, latex=True, plot=""))
    assert got == want and port_out == capsys.readouterr().out


def test_export_torch_writes_the_jax_exporters_files(tmp_path):
    from flax import serialization

    from deepfepe_tpu.frontend import SuperPointNet as JPlain
    from deepfepe_tpu.frontend import SuperPointNetGauss2 as JGauss2
    from deepfepe_tpu.utils.torch_import import (export_deepf_state,
                                                 export_superpoint_gauss2_state)

    out = tmp_path / "deepf.pth.tar"
    cli.main(["export_torch", str(FLAGSHIP / "vo_net" / "config.yml"), CKPT, str(out),
              "--n_iter", "7"])
    ckpt = torch.load(out, weights_only=True)
    want = export_deepf_state(serialization.msgpack_restore(Path(CKPT).read_bytes())["params"])
    assert ckpt["n_iter"] == 7 and set(ckpt["model_state_dict"]) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(ckpt["model_state_dict"][k].numpy(), v, err_msg=k)

    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(JGauss2().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 48, 1), jnp.float32))
    variables = jax.tree_util.tree_map(
        lambda s: jnp.asarray(np.abs(rng.randn(*s.shape)) + 0.1, jnp.float32), shapes)
    sp = tmp_path / "sp.msgpack"
    sp.write_bytes(serialization.to_bytes(variables))
    out = tmp_path / "sp.pth.tar"
    assert cli.export_torch("", str(sp), str(out), superpoint=True)["kind"] == \
        "superpoint_gauss2"
    got = torch.load(out, weights_only=True)["model_state_dict"]
    want = export_superpoint_gauss2_state(jax.device_get(variables))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    plain = jax.eval_shape(JPlain().init, jax.random.PRNGKey(0),
                           jnp.zeros((1, 32, 48, 1), jnp.float32))
    sp.write_bytes(serialization.to_bytes(jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, jnp.float32), plain)))
    with pytest.raises(ValueError, match="SuperPointNetGauss2"):
        cli.export_torch("", str(sp), str(tmp_path / "x.pth.tar"), superpoint=True)
    with pytest.raises(KeyError):  # the solver's file holds no SuperPoint
        cli.export_torch("", CKPT, str(tmp_path / "x.pth.tar"), superpoint=True)


def test_eval_vo_on_a_dump_tree_walks_one_scene_in_frame_order(tree, tmp_path, monkeypatch):
    """A dump tree's test split, one scene (`--scene`): every pair once, in
    frame order (the padded tail skipped by frame_i), the gt trajectory
    chained from the pairs' gt poses, KITTI's segment lengths unless given."""
    monkeypatch.chdir(tmp_path)
    scene = sorted(p.name for p in tree.iterdir() if p.is_dir())[0]
    yml = tmp_path / "vo_tree.yaml"
    yml.write_text(yaml.safe_dump({
        "data": {"dataset": "kitti_odo_corr", "dump_root": str(tree), "batch_size": 4,
                 "good_num": 100, "image": {"size": [376, 1241, 3]},
                 "preprocessing": {"resize": [376, 1240]}},
        "model": {"depth": 2, "mlp_dtype": "float32"}, "training": {"seed": 0}}))
    seen = []
    real = cli.val_rt_batch
    monkeypatch.setattr(cli, "val_rt_batch", lambda *a, **k: seen.append(1) or real(*a, **k))
    rep = cli.main(["eval_vo", str(yml), "tv", "--scene", scene, "--lengths", "1,2",
                    "--device", "cpu"])
    assert rep["n_pairs"] == 5 and len(seen) == 2  # 5 pairs in batches of 4, the tail padded
    assert all(np.isfinite(rep[k]) for k in VO_KEYS)
    gt = np.loadtxt(tmp_path / "logs" / "tv" / "trajectory_gt.txt")
    assert gt.shape == (6, 12)
    np.testing.assert_allclose(gt[0], np.eye(4)[:3].reshape(-1))
    # KITTI's 100-800 m by default: this tree has no such segment, so the
    # segment metrics are NaN (as in the JAX package) and the rest finite.
    rep = cli.eval_vo(load_config(str(yml)), "tv2", scene=scene, device="cpu")
    assert np.isnan(rep["trans_err_pct"]) and np.isnan(rep["rot_err_deg_per_100m"])
    assert all(np.isfinite(rep[k]) for k in ("ATE_m", "RPE_m", "RPE_deg"))


def test_eval_vo_refuses_what_is_not_ported_and_needs_the_card(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = load_config(str(FLAGSHIP / "vo_net" / "config.yml"))
    for flag in ("--pose_graph", "--refine_ba"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            cli.main(["eval_vo", str(FLAGSHIP / "vo_net" / "config.yml"), "x", flag,
                      "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.eval_vo(cfg, "x")
    assert not (tmp_path / "logs").exists()
