"""Port parity: joint training with magicleap's SuperPointNet, the update
guard against the JAX step, and the `train_good` entry point with
`model.if_SP`.

- SuperPointNet (no BatchNorm) at tests/test_joint.py's size, through the
  fused forward with every 3x3 layer on the K5 Function: its joint step
  against the JAX package's as the gauss2 ones are held (equal match
  lists, then in float64 the loss, the gradient norms and every gradient
  leaf; tests/_torch_joint_setup.py). Its gradient path is also held apart
  from the solver, in float32: the SuperPoint gradients of
  `get_matches_from_sp` under fixed cotangents on the correspondences and
  the quality, against jax.grad of the JAX package's module route (its
  route on the CPU; see `run_variant` for its fused route's ReLU), each
  leaf within 1e-4 of its largest entry (float32 convs summed in another
  order; the bar of tests/test_conv_pallas.py's fused-gradient test;
  measured 2.2e-5).
- The min-matches guard one match above the floor: both packages skip.
- `train_good` with `model.if_SP` on a tiny synthetic_images YAML, on the
  CPU: metrics.jsonl, both reference checkpoints (the SuperPoint one with
  its BatchNorm buffers, readable by the JAX package's importer), a
  `pretrained_SP` restore from a `.pth.tar` and from a flax `.msgpack`
  (read since the flax reader was ported; the bf16 SuperPoint and `remat`
  run since they were ported: tests/test_torch_joint_bf16.py).
"""

import importlib
import json

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from _torch_joint_setup import (FP, JFrontendParams, JSuperPointNet, assert_step_matches, batch,
                                jax_variables, jget_matches, port_nets, run_variant)
from deepfepe_tpu.utils.torch_import import load_reference_checkpoint
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.frontend import FrontendParams, get_matches_from_sp
from deepfepe_tpu_torch.ops.conv import full_f32
from deepfepe_tpu_torch.utils.weights import load_superpoint, superpoint_state_from_flax
from _torch_threads import one_torch_thread  # noqa: F401

sp_fused = importlib.import_module("deepfepe_tpu_torch.frontend.sp_fused")


def test_plain_joint_step_matches_jax():
    r = run_variant("plain", "train", fused=True)
    assert_step_matches(r)
    assert r["metrics"]["skipped_update"] == 0.0


def test_plain_guard_skips_with_jax():
    r = run_variant("plain", "train", fused=True, extra_matches=1)
    assert_step_matches(r)
    assert r["metrics"]["skipped_update"] == r["jax_metrics"]["skipped_update"] == 1.0


def test_plain_frontend_gradients_match_jax(monkeypatch):
    sp, deepf = port_nets("plain")
    jv, _ = jax_variables(sp, deepf)
    imgs = batch()["imgs_grey"]
    rng = np.random.RandomState(4)
    c_xy = rng.randn(2, FP["out_num_points"], 4).astype(np.float32)
    c_q = rng.randn(2, FP["out_num_points"], 1).astype(np.float32)
    jfp = JFrontendParams(**FP, conv_backend="flax")

    def jloss(params):
        o = jget_matches(JSuperPointNet(), {"params": params},
                         (jnp.asarray(imgs[:, 0]), jnp.asarray(imgs[:, 1])), jfp)
        return jnp.sum(o["matches_xy_ori"] * c_xy) + jnp.sum(o["quality"] * c_q)

    want = superpoint_state_from_flax({"params": jax.jit(jax.grad(jloss))(jv["params"])})
    monkeypatch.setattr(sp_fused, "MIN_PX_PALLAS", 0)
    t = torch.from_numpy(imgs)
    o = get_matches_from_sp(sp, (t[:, 0], t[:, 1]),
                            FrontendParams(**FP, conv_backend="fused", conv_impl="pallas"))
    with full_f32():  # the plain convs' backward without oneDNN, as the joint step runs it
        (torch.sum(o["matches_xy_ori"] * torch.from_numpy(c_xy))
         + torch.sum(o["quality"] * torch.from_numpy(c_q))).backward()
    for k, p in sp.named_parameters():
        w = want[k].numpy()
        err = float(np.abs(p.grad.numpy() - w).max()) / float(np.abs(w).max())
        assert err < 1e-4, (k, err)


def _joint_yaml(tmp_path, **training):
    cfg = {
        "data": {"dataset": "synthetic_images", "batch_size": 2, "good_num": 64,
                 "image": {"size": [64, 96, 1]}, "preprocessing": {"resize": [64, 96]}},
        "model": {"name": "GoodCorresNet_layers_deepF", "depth": 2, "if_SP": True,
                  "if_quality": True, "mlp_dtype": "float32"},
        "training": {"train_iter": 2, "save_interval": 2, "learning_rate": 1e-4,
                     "train": True, "train_SP": True, "tensorboard": False,
                     "SP_params": {"out_num_points": 64, "conf_thresh": 1e-4, "nms_dist": 4,
                                   "patch_size": 5, "nn_thresh": 1.0},
                     **training},
    }
    p = tmp_path / f"joint_{len(list(tmp_path.glob('joint_*.yaml')))}.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def test_train_good_if_sp_runs_joint_training(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = cli.main(["train_good", _joint_yaml(tmp_path), "jsp", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["n_iter"] == out["n_iter"] == 2
    assert np.isfinite(out["loss"]) and out["num_matches"] > 8 and out["g_sp_norm"] > 0
    assert out["skipped_update"] == 0.0
    exp = tmp_path / "logs" / "jsp"
    lines = [json.loads(x) for x in (exp / "metrics.jsonl").read_text().splitlines()]
    assert [x["iter"] for x in lines] == [0, 1]
    assert all("g_deepf_norm" in x and "min_matches_item" in x for x in lines)
    assert sorted(p.name for p in (exp / "checkpoints").iterdir()) == [
        "deepFNet_2_checkpoint.pth.tar", "superPointNet_2_checkpoint.pth.tar"]
    sp_path = str(exp / "checkpoints" / "superPointNet_2_checkpoint.pth.tar")
    ck = torch.load(sp_path, weights_only=True)
    assert ck["n_iter"] == 2 and ck["optimizer_state_dict"]["state"]
    sd = ck["model_state_dict"]
    assert int(sd["inc.conv.conv.1.num_batches_tracked"]) == 4  # two frames x two steps
    net = load_superpoint(sp_path)
    assert all(torch.equal(v, sd[k]) for k, v in net.state_dict().items())
    variables, _ = load_reference_checkpoint(sp_path, kind="auto")
    np.testing.assert_array_equal(np.asarray(variables["batch_stats"]["inc"]["bn1"]["var"]),
                                  sd["inc.conv.conv.4.running_var"].numpy())
    assert json.loads((exp / "config.yml").read_text())["data"]["with_imgs"] is True


def test_pretrained_sp_restores_the_frontend(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cli.main(["train_good", _joint_yaml(tmp_path), "a", "--device", "cpu"])
    src = tmp_path / "logs" / "a" / "checkpoints" / "superPointNet_2_checkpoint.pth.tar"
    # Stage 1 from it: SuperPoint frozen, its BatchNorm on running statistics.
    cli.main(["train_good", _joint_yaml(tmp_path, train_iter=1, train_SP=False,
                                        retrain_SP=False, pretrained_SP=str(src)),
              "b", "--device", "cpu"])
    before = torch.load(src, weights_only=True)["model_state_dict"]
    after = torch.load(tmp_path / "logs" / "b" / "checkpoints"
                       / "superPointNet_1_checkpoint.pth.tar", weights_only=True)
    assert after["model_state_dict"].keys() == before.keys()
    assert all(torch.equal(v, before[k]) for k, v in after["model_state_dict"].items())


def test_what_the_joint_path_does_not_port_raises(tmp_path, monkeypatch):
    """Since the flax reader was ported nothing of the joint path raises as
    unported: a flax `.msgpack` SuperPoint restores the frontend (stage 1
    leaves it as read), and a `.msgpack` holding no SuperPoint is refused."""
    from flax import serialization

    monkeypatch.chdir(tmp_path)
    cli.main(["train_good", _joint_yaml(tmp_path), "a", "--device", "cpu"])
    src = tmp_path / "logs" / "a" / "checkpoints" / "superPointNet_2_checkpoint.pth.tar"
    variables, _ = load_reference_checkpoint(str(src), kind="auto")
    (tmp_path / "sp.msgpack").write_bytes(serialization.to_bytes(variables))
    cli.main(["train_good", _joint_yaml(tmp_path, train_iter=1, train_SP=False,
                                        retrain_SP=False, pretrained_SP="sp.msgpack"),
              "b", "--device", "cpu"])
    before = torch.load(src, weights_only=True)["model_state_dict"]
    after = torch.load(tmp_path / "logs" / "b" / "checkpoints"
                       / "superPointNet_1_checkpoint.pth.tar", weights_only=True)
    assert after["model_state_dict"].keys() == before.keys()
    assert all(torch.equal(v, before[k]) for k, v in after["model_state_dict"].items()
               if not k.endswith("num_batches_tracked"))
    solver = tmp_path / "deepf.msgpack"
    solver.write_bytes(serialization.to_bytes({"params": {"input_weights": {}}}))
    with pytest.raises(KeyError):
        cli.main(["train_good", _joint_yaml(tmp_path, retrain_SP=False,
                                            pretrained_SP=str(solver)), "x", "--device", "cpu"])
