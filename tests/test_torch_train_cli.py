"""The port's `train_good` and `eval_good --pretrained` on the CPU, and its
checkpoint schema.

- `train_good --device cpu` for 3 steps at good_num 64 writes the config
  snapshot, metrics.jsonl, tfevents and reference-schema `.pth.tar`
  checkpoints.
- `eval_good --pretrained` on that file builds the same net: its F equals
  the live net's exactly (same parameters, same float32 code).
- The file loads into the JAX package through
  `load_reference_checkpoint(..., kind="deepf")`, and the JAX forward with
  those parameters gives the port's F within 1e-4 on unit-norm F, in
  float64 with sign-canonical null vectors on both sides (measured 8e-15).
- `to_reference_layout` round-trips a state_dict through the reference's
  Conv1d layout.
"""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepfepe_tpu.models.deepfnet import DeepFNet as JDeepFNet
from deepfepe_tpu.utils.torch_import import load_reference_checkpoint
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.models import DeepFNet
from deepfepe_tpu_torch.train import Trainer, config_from_dict, eval_step, load_checkpoint
from deepfepe_tpu_torch.utils.weights import to_reference_layout
from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SIZE = (376, 1241)
YAML = """
data: {dataset: synthetic, batch_size: 2, good_num: 64, image: {size: [376, 1241, 3]},
       preprocessing: {resize: [376, 1241]}}
model: {depth: 2, if_quality: true, quality_size: 1, use_pallas_mlp: %s}
training: {seed: 0, learning_rate: 0.0001, val_interval: 2, val_batches: 1,
           save_interval: 2, train_iter: 100}
"""


def _write_config(tmp_path, fused=False):
    path = tmp_path / "cfg.yaml"
    path.write_text(YAML % ("true" if fused else "false"))
    return str(path)


def _unit(F):
    F = np.asarray(F, np.float64)
    return F / np.linalg.norm(F, axis=(-1, -2), keepdims=True)


@pytest.mark.parametrize("fused", [False, True])
def test_train_good_writes_logs_and_checkpoints(tmp_path, monkeypatch, capsys, fused):
    monkeypatch.chdir(tmp_path)
    cli.main(["train_good", _write_config(tmp_path, fused), "exp", "--train_iter", "3",
              "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["n_iter"] == 3 and np.isfinite(last["loss"]) and last["nonfinite"] == 0.0
    exp = tmp_path / "logs" / "exp"
    assert json.loads((exp / "config.yml").read_text())["model"]["use_pallas_mlp"] is fused
    recs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in recs if r["tag"] == "train"] == [0, 1, 2]
    assert any(r["tag"] == "val" for r in recs)
    assert list((exp / "runs").glob("events.out.tfevents.*"))
    ckpts = sorted(p.name for p in (exp / "checkpoints").iterdir())
    assert ckpts == ["deepFNet_2_checkpoint.pth.tar", "deepFNet_3_checkpoint.pth.tar",
                     "deepFNet_best_checkpoint.pth.tar"]
    ck = torch.load(exp / "checkpoints" / "deepFNet_3_checkpoint.pth.tar", weights_only=True)
    assert set(ck) == {"n_iter", "n_iter_val", "model_state_dict", "optimizer_state_dict",
                       "loss"}
    assert ck["n_iter"] == 3 and ck["n_iter_val"] == 1
    assert ck["model_state_dict"]["input_weights.fw.0.weight"].shape == (64, 5, 1)
    assert ck["model_state_dict"]["update_weights.fw.15.weight"].shape == (1, 256, 1)
    steps = {int(s["step"]) for s in ck["optimizer_state_dict"]["state"].values()}
    assert steps == {3}  # the real Adam state, every parameter stepped three times


def _trained(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = config_from_dict({"data": {"batch_size": 2, "good_num": 64},
                            "model": {"depth": 2, "if_quality": True, "mlp_dtype": "float32"},
                            "training": {"val_interval": 0, "save_interval": 0}})
    net = cli.model_loader(cfg, torch.device("cpu"), torch.Generator().manual_seed(1), train=True)
    net.sign_canonical = True
    trainer = Trainer(net, cfg, save_dir=str(tmp_path / "logs" / "t"))
    ds = importlib.import_module("deepfepe_tpu_torch.loader").data_loader(cfg, "train")
    trainer.fit(ds.batches(2), max_iters=2)
    return cfg, trainer, trainer.save(2)


def test_eval_good_pretrained_reads_back_the_live_net(tmp_path, monkeypatch):
    cfg, trainer, path = _trained(tmp_path, monkeypatch)
    built = []
    real = cli.model_loader
    monkeypatch.setattr(cli, "model_loader", lambda *a, **k: built.append(real(*a, **k))
                        or built[-1])
    summary = cli.eval_good(cfg, 1, device="cpu", pretrained=path)
    assert summary["pairs"] == 2 and np.isfinite(summary["loss_F"])
    loaded = built[0]
    loaded.sign_canonical = True  # as the live net, so the forward is the same code
    batch = {k: torch.tensor(v) for k, v in cli.data_loader(cfg, "test").batch(2).items()}
    F_live = eval_step(trainer.net, batch, cfg)["F_ests"]
    F_read = eval_step(loaded, batch, cfg)["F_ests"]
    assert torch.equal(F_live, F_read)
    for k, v in trainer.net.state_dict().items():
        assert torch.equal(v, loaded.state_dict()[k]), k


def test_checkpoint_loads_into_the_jax_package(tmp_path, monkeypatch):
    cfg, trainer, path = _trained(tmp_path, monkeypatch)
    variables, n_iter = load_reference_checkpoint(path, kind="deepf")
    assert n_iter == 2
    batch = cli.data_loader(cfg, "test").batch(2)
    batch = {"matches_xy_ori": batch["matches_xy_ori"].astype(np.float64),
             "quality": batch["quality"]}
    jnet = JDeepFNet(depth=2, image_size=trainer.net.image_size, if_quality=True,
                     mlp_dtype=jnp.float64, sign_canonical=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree_util.tree_map(
        lambda a, b: jnp.asarray(b, jnp.float64),
        jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jb),
        jax.tree_util.tree_map(np.asarray, variables))
    F_jax = jax.jit(jnet.apply)(jparams, jb)["F_est"]
    net = trainer.net.double()
    net.input_weights.dtype = net.update_weights.dtype = torch.float64
    with torch.no_grad():
        F_port = net({k: torch.tensor(v) for k, v in batch.items()})["F_est"]
    np.testing.assert_allclose(_unit(F_port), _unit(F_jax), atol=1e-4)


def test_reference_layout_round_trip():
    net = DeepFNet(depth=2, image_size=SIZE, if_quality=True)
    net.reset_parameters(torch.Generator().manual_seed(2))
    ref = to_reference_layout(net.state_dict())
    assert ref["input_weights.fw.6.weight"].shape == (1024, 128, 1)
    assert ref["input_weights.fw.7.weight"].shape == (1024,)
    other = DeepFNet(depth=2, image_size=SIZE, if_quality=True)
    other.load_state_dict(ref, strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k


def test_restore_resumes_parameters_adam_state_and_iteration(tmp_path, monkeypatch):
    cfg, trainer, path = _trained(tmp_path, monkeypatch)
    net = cli.model_loader(cfg, torch.device("cpu"))
    other = Trainer(net, cfg)
    assert other.restore(path) == 2
    for k, v in trainer.net.state_dict().items():
        assert torch.equal(v, other.net.state_dict()[k])
    a, b = trainer.opt.state_dict()["state"], other.opt.state_dict()["state"]
    assert a.keys() == b.keys()
    for i in a:
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k])
    assert load_checkpoint(path, net) == 2


def test_val_in_train_window_logs_training_means(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = config_from_dict({"data": {"batch_size": 2, "good_num": 64},
                            "model": {"depth": 2, "if_quality": True, "mlp_dtype": "float32"},
                            "training": {"val_interval": 0, "save_interval": 0,
                                         "val_interval_in_train": 2, "val_batches": 1,
                                         "tensorboard": False}})
    trainer = Trainer(cli.model_loader(cfg, torch.device("cpu"), train=True), cfg,
                      save_dir=str(tmp_path / "logs" / "v"))
    trainer.fit(cli.data_loader(cfg, "train").batches(2), max_iters=4)
    trainer.logger.close()
    recs = [json.loads(line) for line in
            (tmp_path / "logs" / "v" / "metrics.jsonl").read_text().splitlines()]
    window = [r for r in recs if r["tag"] == "training"]
    # The window opens at iteration 2 and averages the eval metrics of
    # val_batches + 1 training batches (iterations 2 and 3), as in JAX.
    assert [r["iter"] for r in window] == [3]
    assert np.isfinite(window[0]["loss_F"])
