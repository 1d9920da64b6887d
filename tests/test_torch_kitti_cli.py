"""The port's CLI over dump trees, against the JAX CLI.

- `train_good` walks the train split epoch after epoch: over a fake dump
  of 10 pairs in batches of 4 (two a pass, the tail dropped), 5 steps take
  the pairs that the JAX CLI's `cycle` takes from the JAX dataset with the
  same seed, in the same order (`frame_ids` equal), and an empty split
  raises.
- `eval_good` on the same dump (10 pairs in batches of 8: a short tail),
  the same seeded weights (a `.pth.tar` both CLIs load) and the RANSAC
  draws of the JAX `cmd_eval` (PRNGKey(0) split once a batch, replayed as
  indices): the two npz dumps have the same file names, key set and rows
  (10: the tail padded and trimmed). The solver's rows (`err_q`, `err_t`,
  `relative_poses_*`, `epi_dists`) agree within float32's bars of
  tests/test_torch_eval_good.py (0.05 deg + 1% on errors, 2e-3 on pose
  entries and 1% on epipolar distances); the 8-point baseline's float32
  minimal fits differ between the packages (tests/test_torch_ransac.py),
  so its rows are held to their shapes and to the RANSAC health bar.
  With `exps.five_point` the port writes the same files and keys.
"""

import json

import numpy as np
import pytest
import torch

import jax

from _jax_cli_fast import patch_jax_cli
from deepfepe_tpu import cli as j_cli
from deepfepe_tpu.data.kitti import KittiCorrDataset as JKitti
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.data.synthetic_dump import write_corr_dump
from deepfepe_tpu_torch.loader import data_loader, model_loader
from deepfepe_tpu_torch.train import config_from_dict, load_config, save_checkpoint
from _torch_threads import one_torch_thread  # noqa: F401

KEYS = {"err_q", "err_t", "epi_dists", "relative_poses_cam", "relative_poses_body"}
YAML = """
data: {{dataset: kitti_odo_corr, dump_root: '{root}', batch_size: {bs}, good_num: 128,
       image: {{size: [376, 1241, 3]}}, preprocessing: {{resize: [376, 1240]}}}}
model: {{depth: 2, clamp_at: 0.02, mlp_dtype: float32}}
exps: {{five_point: {five}, base_name: ransac_8p, our_name: DeepF, filename: err_ratio.npz}}
training: {{seed: 0, train_iter: 5, val_interval: 0, save_interval: 0, retrain: true}}
"""


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    root = tmp_path_factory.mktemp("dump")
    write_corr_dump(root, scenes=2, frames=6, matches=160, seed=2)
    return root


def write_yaml(tmp_path, dump, bs=8, five=False):
    path = tmp_path / f"kitti_{bs}_{five}.yaml"
    path.write_text(YAML.format(root=dump, bs=bs, five=str(five).lower()))
    return str(path)


def test_train_good_walks_epochs_as_jax(dump, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = load_config(write_yaml(tmp_path, dump, bs=4))
    seen = []
    real = cli.Trainer.fit

    def fit(self, stream, *a, **k):
        def record():
            for b in stream:
                seen.append(b["frame_ids"].copy())
                yield b
        return real(self, record(), *a, **k)

    monkeypatch.setattr(cli.Trainer, "fit", fit)
    last = cli.train_good(cfg, "kt", device="cpu")
    assert last["n_iter"] == 5 and np.isfinite(last["loss"])
    assert (tmp_path / "logs" / "kt" / "checkpoints" / "deepFNet_5_checkpoint.pth.tar").exists()
    jds = JKitti(str(dump), good_num=128, image_size=(376, 1241), resize=(376, 1240), seed=0)
    want = [b["frame_ids"] for _ in range(3) for b in jds.batches(4)]
    assert len(seen) >= 5
    for got, ref in zip(seen[:5], want):
        np.testing.assert_array_equal(got, ref)
    empty = config_from_dict({"data": {"dataset": "kitti_odo_corr", "dump_root": str(dump),
                                       "batch_size": 64, "good_num": 32},
                              "training": {"train_iter": 2, "val_interval": 0}})
    with pytest.raises(RuntimeError, match="no batches"):
        cli.train_good(empty, "empty", device="cpu")


def jax_draws(n_batches, B, N, H=512):
    key, out = jax.random.PRNGKey(0), []
    for _ in range(n_batches):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.stack([np.asarray(jax.random.randint(k, (H, 8), 0, N))
                                              for k in jax.random.split(sub, B)])))
    return out


def test_eval_good_writes_the_jax_dumps(dump, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    yaml = write_yaml(tmp_path, dump)
    cfg = load_config(yaml)
    net = model_loader(cfg, torch.device("cpu"), torch.Generator().manual_seed(5))
    ckpt = str(tmp_path / "w.pth.tar")
    save_checkpoint(ckpt, net, None, 0)

    patch_jax_cli(monkeypatch)  # the same numbers, fewer compiles
    j_cli.main(["eval_good", yaml, "jx", "--pretrained", ckpt])
    jsum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    data = cli.eval_batches(cfg, data_loader(cfg, "test"), 0)
    assert [len(b["Ks"]) for b in data] == [8, 2]
    res = cli.evaluate(cfg, net, data, torch.device("cpu"), ransac_idxs=jax_draws(2, 8, 128),
                       pad_to=8)
    cli.save_eval_dumps(cfg, res, str(tmp_path))
    assert jsum["pairs"] == len(res["err_q_est"]) == 10
    for name in ("DeepF_err_ratio.npz", "ransac_8p_err_ratio.npz"):
        a, b = np.load(tmp_path / "logs" / "jx" / name), np.load(tmp_path / name)
        assert set(a.files) == set(b.files) == KEYS, name
        for k in KEYS:
            assert a[k].shape == b[k].shape and a[k].shape[0] == 10, (name, k)
    a, b = np.load(tmp_path / "logs" / "jx" / "DeepF_err_ratio.npz"), np.load(
        tmp_path / "DeepF_err_ratio.npz")
    for k in ("err_q", "err_t"):
        np.testing.assert_allclose(b[k], a[k], atol=5e-2, rtol=1e-2, err_msg=k)
    for k in ("relative_poses_cam", "relative_poses_body"):
        np.testing.assert_allclose(b[k], a[k], atol=2e-3, err_msg=k)
    np.testing.assert_allclose(b["epi_dists"], a["epi_dists"], rtol=1e-2, atol=1e-3)
    base = np.load(tmp_path / "ransac_8p_err_ratio.npz")
    assert np.median(base["err_q"]) < 0.5 and np.median(jsum["median_err_q_base"]) < 0.5
    assert np.abs(res["base_inliers"]).min() > 0.5 * 128

    for five in (False, True):  # the CLI end to end, on its own draws
        cli.main(["eval_good", write_yaml(tmp_path, dump, five=five), f"t{five}", "--max_batches",
                  "0", "--device", "cpu", "--pretrained", ckpt])
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["pairs"] == 10 and summary["median_err_q_gt"] < 1e-3
        # A sanity bar: at N = 128 with 15% outliers the baselines' own
        # draws land 0.3-0.8 deg off (a wrong E is tens of degrees off).
        assert summary["median_err_q_base"] < 2.0, (five, summary)
        for name in ("DeepF_err_ratio.npz", "ransac_8p_err_ratio.npz"):
            z = np.load(tmp_path / "logs" / f"t{five}" / name)
            assert set(z.files) == KEYS and len(z["err_q"]) == 10
        assert (tmp_path / "logs" / f"t{five}" / "config.yml").exists()


def test_eval_good_max_batches_and_the_synthetic_stream(dump, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = load_config(write_yaml(tmp_path, dump, bs=4))
    assert [len(b["Ks"]) for b in cli.eval_batches(cfg, data_loader(cfg, "test"), 2)] == [4, 4]
    synth = config_from_dict({"data": {"batch_size": 2, "good_num": 32}})
    with pytest.raises(ValueError, match="endless"):
        cli.eval_batches(synth, data_loader(synth, "test"), 0)


def test_metrics_summary_equals_jax():
    """The numpy copy of the eval summaries: equal dicts on the same
    per-pair arrays."""
    from deepfepe_tpu.eval import metrics_summary as j_ms
    from deepfepe_tpu_torch.eval import metrics_summary as t_ms

    rng = np.random.RandomState(0)
    err_q, err_t = rng.rand(40) * 3, rng.rand(40) * 20
    epi, w, gt = rng.rand(40, 50) * 2, rng.rand(40, 50), rng.rand(40, 50) * 3
    for args in ((err_q, err_t), (err_q, err_t, epi), (err_q, err_t, epi, w / 25, gt)):
        assert t_ms.summarize(*args) == j_ms.summarize(*args)
    assert t_ms.weight_f1(w, gt, 0.5) == j_ms.weight_f1(w, gt, 0.5)
