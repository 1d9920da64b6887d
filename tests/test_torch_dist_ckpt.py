"""Port parity: `train/dist_ckpt.py` (sharded checkpoints over
torch.distributed.checkpoint) against the JAX package's
`train/orbax_ckpt.py`, and `launch/train_multihost.py` at 2 processes
against 1.

tests/test_orbax_ckpt.py's three cases, in a world of two CPU ranks under
gloo (`tests/_torch_dist.py`, suite 'ckpt'):

- components: deepF (the solver's state and n_iter) and superPoint in one
  checkpoint; deepF restored alone, then both, equal to what was saved;
- sharding at restore: the solver tensor-parallel over the two ranks, its
  wide leaves saved as their shards (one data file a rank) and each
  rank's shards restored into a fresh sharded net, equal to the slices of
  the whole weights;
- rotation: max_to_keep 2 over steps 100, 200, 300 keeps [200, 300] (as
  Orbax's manager keeps, run here on the same steps) and restores 300;
  with best_fn_metric the two lowest.

The launcher (suite-free: its own processes) trains 2 steps at 2
processes and at 1 on the same config: the losses of step 0 agree to
1e-6 and of step 1 to 5e-4 relative (tests/test_multihost_launcher.py's
bars: one gradient all-reduce sums in another order), only rank 0 writes
under logs/, and `--pretrained` on the 2-process checkpoint continues at
step 2.
"""

import json
import os
import subprocess

import numpy as np
import orbax.checkpoint as ocp
import pytest

from deepfepe_tpu_torch.parallel.spawn import python_module, run_world
from _torch_dist import World
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LAUNCHER = "deepfepe_tpu_torch.launch.train_multihost"


@pytest.fixture(scope="module")
def world():
    return World("ckpt", WORLD)


@pytest.fixture(scope="module")
def results(world):
    return world.result()


def test_save_restore_components(results):
    for r in results:
        c = r["components"]
        assert c["keys"] == ["deepF"] and c["n_iter"] == 7
        assert c["equal"] and c["sp_equal"]


def test_restore_tensor_parallel_shards(results):
    for rank, r in enumerate(results):
        t = r["tp"]
        assert t["files"] == [".metadata", "__0_0.distcp", "__1_0.distcp"]
        assert t["equal"]
        assert t["sharded_keys"] and all(k.endswith(f"#shard{rank}of2") for k in t["sharded_keys"])
        for k, whole in t["whole"].items():
            local = t["local"][k]
            if local.shape != whole.shape:
                half = whole.shape[0] // 2
                np.testing.assert_array_equal(local, whole[rank * half:(rank + 1) * half])
            else:
                np.testing.assert_array_equal(local, whole)


def test_checkpoint_manager_rotation(results, tmp_path):
    mgr = ocp.CheckpointManager(str(tmp_path / "orbax"),
                                options=ocp.CheckpointManagerOptions(max_to_keep=2))
    for step in (100, 200, 300):
        mgr.save(step, args=ocp.args.StandardSave({"solver": {"w": np.full(4, step, np.float32)}}))
    mgr.wait_until_finished()
    orbax_steps = sorted(mgr.all_steps())
    mgr.close()
    for r in results:
        rot = r["rotation"]
        assert rot["steps"] == orbax_steps == [200, 300]
        np.testing.assert_array_equal(rot["latest"], np.full(4, 300.0))
        assert rot["best_steps"] == [2, 4]


def _launcher_config(path, train_iter):
    cfg = {"data": {"dataset": "synthetic", "batch_size": 8, "good_num": 64,
                    "image": {"size": [120, 160, 3]}, "preprocessing": {"resize": [120, 160]}},
           "model": {"depth": 2, "clamp_at": 0.02, "mlp_dtype": "float32"},
           "training": {"learning_rate": 1.0e-4, "train_iter": train_iter, "save_interval": 2,
                        "seed": 0, "val_interval": 0, "tensorboard": False}}
    path.write_text(json.dumps(cfg))


def _launch(tmp_path, cfg, exper, n, *extra):
    return run_world(lambda r, c: python_module(
        LAUNCHER, "--config", str(cfg), "--exper", exper, "--backend", "gloo", "--device", "cpu",
        "--coordinator", c, "--num_processes", str(n), "--process_id", str(r), *extra),
        n, 300.0, cwd=str(tmp_path), env={"OMP_NUM_THREADS": "1"})


def _train_losses(tmp_path, exper):
    lines = (tmp_path / "logs" / exper / "metrics.jsonl").read_text().splitlines()
    return {r["iter"]: r["loss"] for r in map(json.loads, lines) if r["tag"] == "train"}


def test_launcher_two_processes_match_one(results, tmp_path):
    cfg = tmp_path / "mh.json"
    _launcher_config(cfg, 2)
    outs = _launch(tmp_path, cfg, "mh2", 2)
    assert "processes=2 backend=gloo" in outs[0] and "done:" in outs[0]
    assert "done:" not in outs[1]
    ckpt = tmp_path / "logs" / "mh2" / "checkpoints" / "deepFNet_2_checkpoint.pth.tar"
    assert ckpt.exists()
    assert sorted(p.name for p in (tmp_path / "logs").iterdir()) == ["mh2"]
    mp = _train_losses(tmp_path, "mh2")
    _launch(tmp_path, cfg, "mh1", 1)
    sp = _train_losses(tmp_path, "mh1")
    assert set(mp) == set(sp) == {0, 1}
    np.testing.assert_allclose(mp[0], sp[0], rtol=1e-6)
    np.testing.assert_allclose(mp[1], sp[1], rtol=5e-4)

    # Resume: the 2-process checkpoint in a fresh 2-process job, to step 3.
    _launcher_config(cfg, 3)
    outs = _launch(tmp_path, cfg, "mh2r", 2, "--pretrained", str(ckpt))
    assert "restored from" in outs[0] and "@ iter 2" in outs[0]
    assert set(_train_losses(tmp_path, "mh2r")) == {2}


def test_launcher_refuses_without_a_world(tmp_path):
    """No --coordinator and no torchrun environment: a clear error, no
    single-process fallback."""
    cfg = tmp_path / "mh.json"
    _launcher_config(cfg, 1)
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = REPO
    p = subprocess.run(python_module(LAUNCHER, "--config", str(cfg), "--exper", "x",
                                     "--backend", "gloo", "--device", "cpu"),
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and "torchrun environment" in p.stderr
