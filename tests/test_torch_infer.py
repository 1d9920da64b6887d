"""Port parity for the serving entry `infer`, the flax SuperPoint files and
the ablation driver.

- `infer` on frames 0 and 5 of a SyntheticImageSequence (120x160), with a
  seeded SuperPointNetGauss2 `.pth.tar` (zero-centred BatchNorm means, as
  chip_smoke.py's `gauss2_checkpoint`: the untrained net then keeps its
  activations) and the flagship solver, against the JAX CLI's `cmd_infer`
  on the same files. The JAX run's DeepFNet template comes from
  `jax.eval_shape` (the checkpoint overwrites every leaf); nothing else is
  changed. Bars: the same match count; the epipolar inlier ratio within
  one match and the median distance within 1% + 1e-4 px (on this pair the
  median is ~1e-3 px, the float32 F's own rounding, which moves it by
  1e-5 px); R, t_unit and E (unit
  Frobenius norm, sign-aligned) within 2e-3: the solver's float32 rounding
  (tests/test_torch_eval_good.py's F bar on the card is 1e-3) through a
  float64 decomposition.
- `infer` without `--pretrained_SP` (the SIFT frontend: ratio-0.8
  matches at 2 good_num features, sampled by `crop_or_pad_choice` with
  RandomState(0), quality / 300) against the JAX CLI's SIFT branch
  (OpenCV's SIFT and BFMatcher) on the same frames: the same match count
  and the solver's pose at the bars above.
- What `infer` does not port raises: JPEG forms the native decoder refuses
  (ROADMAP Queue 1 item 9).
- `load_superpoint` reads the JAX package's flax `.msgpack` variables
  (gauss2 with batch statistics, or the plain net) into the net the JAX
  importer's state dict gives, and `val_feature --pretrained` takes one.
- `run_eval` builds one port CLI process a cell and reads its JSON line.
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

from deepfepe_tpu import cli as j_cli
from deepfepe_tpu.models import DeepFNet as JDeepFNet
from deepfepe_tpu_torch import cli, run_eval
from deepfepe_tpu_torch.data import SyntheticImageSequence
from deepfepe_tpu_torch.frontend import SuperPointNet, SuperPointNetGauss2
from deepfepe_tpu_torch.frontend.superpoint import reset_superpoint
from deepfepe_tpu_torch.utils.image_io import write_png
from deepfepe_tpu_torch.utils.weights import load_superpoint, superpoint_state_from_flax
from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CKPT = str(REPO / "experiments" / "flagship" / "ckpt_qt_best.msgpack")
SIZE, GOOD_NUM = (120, 160), 300
POSE_BAR = 2e-3


def gauss2_checkpoint(path, seed=0):
    g = torch.Generator().manual_seed(seed)
    net = reset_superpoint(SuperPointNetGauss2(), g)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=g))
                m.running_var.copy_((1 + 0.3 * torch.randn(m.num_features, generator=g)).abs()
                                    + 0.05)
    torch.save({"n_iter": 0, "model_state_dict": net.state_dict()}, path)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer")
    # Frames 0 and 5, 1.5 m apart: enough parallax that F is well posed
    # (consecutive frames of the default sequence move a pixel or less).
    seq = SyntheticImageSequence(n_frames=6, image_size=SIZE, step_length=0.3, seed=1)
    frames = []
    for k in (0, 5):
        frames.append(str(root / f"{k:06d}.png"))
        write_png(frames[-1], np.rint(seq.frame(k) * 255).astype(np.uint8))
    sp = str(root / "sp_gauss2.pth.tar")
    gauss2_checkpoint(sp)
    K = seq.K
    return {"root": root, "frames": frames, "sp": sp,
            "K": f"{K[0, 0]},{K[1, 1]},{K[0, 2]},{K[1, 2]}"}


@pytest.fixture(scope="module")
def jax_infer(pair):
    import flax.linen as nn

    from deepfepe_tpu import frontend as j_frontend

    def template(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda *a: nn.Module.init(self, rngs, *a, **kw), *args)
        return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    def jitted_apply(self, variables, *args, **kw):
        return jax.jit(lambda v, *a: nn.Module.apply(self, v, *a, **kw))(variables, *args)

    real_matches = j_frontend.get_matches_from_sp

    def jitted_matches(net, params, imgs, fp):
        return jax.jit(lambda p, a, b: real_matches(net, p, (a, b), fp))(params, *imgs)

    with pytest.MonkeyPatch.context() as mp:
        for cls in (JDeepFNet, j_frontend.SuperPointNet, j_frontend.SuperPointNetGauss2):
            mp.setattr(cls, "init", template)
        mp.setattr(JDeepFNet, "apply", jitted_apply)
        mp.setattr(j_frontend, "get_matches_from_sp", jitted_matches)
        return {sp: j_cli.cmd_infer(types.SimpleNamespace(
            img1=pair["frames"][0], img2=pair["frames"][1], pretrained=CKPT,
            pretrained_SP=sp, K=pair["K"], config="", good_num=GOOD_NUM,
            out=str(pair["root"] / "jax.json"))) for sp in (pair["sp"], "")}


def _unit(E):
    E = np.asarray(E, np.float64)
    E = E / np.linalg.norm(E)
    return E * np.sign(E.flat[np.abs(E).argmax()])


def test_infer_matches_jax(pair, jax_infer, capsys):
    out = pair["root"] / "port.json"
    got = cli.main(["infer", *pair["frames"], "--pretrained", CKPT, "--pretrained_SP",
                    pair["sp"], "--K", pair["K"], "--good_num", str(GOOD_NUM), "--out",
                    str(out), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert json.loads(out.read_text()) == got
    want = jax_infer[pair["sp"]]
    assert set(got) == set(want) and got["frontend"] == want["frontend"] == "superpoint"
    assert got["num_matches"] == want["num_matches"] >= 8
    assert abs(got["epi_inlier_ratio_1px"] - want["epi_inlier_ratio_1px"]) <= 1.0 / GOOD_NUM
    assert abs(got["epi_median_px"] - want["epi_median_px"]) \
        <= 1e-2 * want["epi_median_px"] + 1e-4
    R = np.asarray(got["R"])
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-9)
    np.testing.assert_allclose(R, want["R"], atol=POSE_BAR)
    np.testing.assert_allclose(got["t_unit"], want["t_unit"], atol=POSE_BAR)
    np.testing.assert_allclose(_unit(got["E"]), _unit(want["E"]), atol=POSE_BAR)


def test_infer_sift_matches_jax(pair, jax_infer):
    got = cli.main(["infer", *pair["frames"], "--pretrained", CKPT, "--K", pair["K"],
                    "--good_num", str(GOOD_NUM), "--device", "cpu"])
    want = jax_infer[""]
    assert set(got) == set(want) and got["frontend"] == want["frontend"] == "sift"
    assert got["num_matches"] == want["num_matches"] >= 8
    assert abs(got["epi_inlier_ratio_1px"] - want["epi_inlier_ratio_1px"]) <= 1.0 / GOOD_NUM
    assert abs(got["epi_median_px"] - want["epi_median_px"]) \
        <= 1e-2 * want["epi_median_px"] + 1e-4
    np.testing.assert_allclose(got["R"], want["R"], atol=POSE_BAR)
    np.testing.assert_allclose(got["t_unit"], want["t_unit"], atol=POSE_BAR)
    np.testing.assert_allclose(_unit(got["E"]), _unit(want["E"]), atol=POSE_BAR)


def test_infer_with_a_config_and_a_reference_solver_file(pair, tmp_path):
    """--config builds the solver at the frames' size; a `.pth.tar` export
    of the flagship gives the `.msgpack`'s pose."""
    ref = tmp_path / "deepf.pth.tar"
    cfg_path = str(REPO / "experiments" / "flagship" / "vo_net" / "config.yml")
    cli.export_torch(cfg_path, CKPT, str(ref))
    raw = yaml.safe_load(Path(cfg_path).read_text())
    raw["model"]["mlp_dtype"] = "float32"
    small = tmp_path / "c.yml"
    small.write_text(yaml.safe_dump(raw))
    kw = dict(K=pair["K"], good_num=GOOD_NUM, device="cpu")
    a = cli.infer(*pair["frames"], CKPT, pair["sp"], **kw)
    b = cli.infer(*pair["frames"], str(ref), pair["sp"], config=str(small), **kw)
    assert a == b


def test_infer_refuses_what_is_not_ported(pair, tmp_path, monkeypatch):
    jpg = tmp_path / "a.jpg"  # an arithmetic-coded (SOF9) frame header
    jpg.write_bytes(b"\xff\xd8\xff\xc9\x00\x0b\x08\x00\x10\x00\x10\x01\x01\x11\x00\xff\xd9")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        cli.infer(str(jpg), str(jpg), CKPT, pair["sp"], device="cpu")
    with pytest.raises(SystemExit, match="SuperPoint matches"):  # 4 keypoints a frame
        cli.infer(*pair["frames"], CKPT, pair["sp"], good_num=4, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.infer(*pair["frames"], CKPT, pair["sp"])


def _flax_variables(net_cls, seed):
    from deepfepe_tpu.frontend import SuperPointNet as JPlain
    from deepfepe_tpu.frontend import SuperPointNetGauss2 as JGauss2

    jnet = {"plain": JPlain, "gauss2": JGauss2}[net_cls]()
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 48, 1), jnp.float32))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(np.abs(rng.randn(*s.shape)) * 0.2 + 0.05, jnp.float32), shapes)


@pytest.mark.parametrize("kind", ["plain", "gauss2"])
def test_load_superpoint_reads_flax_msgpack(kind, tmp_path):
    from flax import serialization

    variables = _flax_variables(kind, 1)
    path = tmp_path / f"{kind}.msgpack"
    path.write_bytes(serialization.to_bytes(variables))
    net = load_superpoint(str(path))
    assert type(net) is (SuperPointNetGauss2 if kind == "gauss2" else SuperPointNet)
    want = superpoint_state_from_flax(jax.device_get(variables))
    got = net.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v.reshape(got[k].shape)) for k, v in want.items())


def test_val_feature_takes_a_flax_superpoint(tmp_path, monkeypatch):
    from flax import serialization

    monkeypatch.chdir(tmp_path)
    (tmp_path / "sp.msgpack").write_bytes(serialization.to_bytes(_flax_variables("gauss2", 2)))
    summary = cli.val_feature("vf", max_batches=1, pretrained="sp.msgpack", device="cpu")
    assert summary["pairs"] == 2 and np.isfinite(summary["num_matches"])


def test_run_eval_runs_one_port_process_a_cell(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = tmp_path / "base.yaml"
    base.write_text(yaml.safe_dump({"data": {"batch_size": 2, "good_num": 64},
                                    "model": {"depth": 2, "mlp_dtype": "float32"}}))
    cells = {"d2": {}, "d3": {"overrides": {"model": {"depth": 3}},
                              "pretrained": "missing.pth.tar"}}
    ablation = tmp_path / "abl.yaml"
    ablation.write_text(yaml.safe_dump(cells))
    out = "logs/abl"
    dry = run_eval.run_ablations(str(base), str(ablation), out, max_batches=1, dry_run=True,
                                 device="cpu")
    assert dry["d3"]["cmd"][1:4] == ["-m", "deepfepe_tpu_torch.cli", "eval_good"]
    assert dry["d3"]["cmd"][-6:] == ["--pretrained", "missing.pth.tar", "--max_batches", "1",
                                     "--device", "cpu"]
    assert yaml.safe_load((tmp_path / out / "temp_config_d3.yaml").read_text())["model"] == {
        "depth": 3, "mlp_dtype": "float32"}
    one = tmp_path / "one.yaml"
    one.write_text(yaml.safe_dump({"d2": {}}))
    res = run_eval.run_ablations(str(base), str(one), out, max_batches=1, device="cpu")
    assert res["d2"]["pairs"] == 2 and res["d2"]["device"] == "cpu", res
    assert json.loads((tmp_path / out / "ablation_results.json").read_text()) == res
    assert run_eval.check_exist(cells, out) == {"d2": {"checkpoint": True, "results": True},
                                                "d3": {"checkpoint": False, "results": False}}
