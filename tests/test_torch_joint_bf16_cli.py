"""The joint path's entry point with a bf16 SuperPoint and over dump trees:
`train_good` with `model.if_SP` and `model.mlp_dtype: bfloat16`, on the CPU.

- On a tiny `synthetic_images` YAML: the run builds the bf16 frontend,
  trains both nets and writes both reference checkpoints; the SuperPoint
  one is float32 throughout (parameters and BatchNorm buffers) and loads
  through the JAX package's importer, and back into a bf16 net through
  `load_superpoint`. With `SP_params.remat: block`, stage 2 (train-mode
  BatchNorm) and stage 1 (SuperPoint frozen, from the checkpoint) run and
  stage 1 leaves the SuperPoint file's values as they were.
- Over a PNG dump tree (`dump_sequence_sp` on `SyntheticImageSequence`
  frames, as tests/test_torch_dump_kitti.py builds one; 4 pairs in batches
  of 2, 3 steps: across an epoch boundary): the pairs the port's steps
  take, in order, equal those the JAX CLI's joint `cmd_train` takes on the
  same tree and seed (its step replaced by a recorder: both CLIs draw one
  batch first, then cycle the epochs).
- A tree whose train split holds no batch raises.
"""

import json

import numpy as np
import pytest
import torch
import yaml

from deepfepe_tpu import cli as j_cli
from deepfepe_tpu.train import joint as j_joint
from deepfepe_tpu.utils.torch_import import load_reference_checkpoint
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.data import SyntheticImageSequence
from deepfepe_tpu_torch.data.dump_kitti import dump_sequence_sp
from deepfepe_tpu_torch.frontend import SuperPointNet
from deepfepe_tpu_torch.utils.image_io import write_png
from deepfepe_tpu_torch.utils.weights import load_superpoint

from test_torch_joint_cli import _joint_yaml


def _bf16(path, **sp_params):
    cfg = yaml.safe_load(open(path))
    cfg["model"]["mlp_dtype"] = "bfloat16"
    cfg["training"]["SP_params"].update(sp_params)
    out = path.replace(".yaml", "_bf16.yaml")
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f)
    return out


def test_bf16_joint_training_writes_float32_checkpoints(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = cli.main(["train_good", _bf16(_joint_yaml(tmp_path)), "jb", "--device", "cpu"])
    assert out["n_iter"] == 2 and np.isfinite(out["loss"]) and out["g_sp_norm"] > 0
    assert out["skipped_update"] == 0.0
    sp_path = tmp_path / "logs" / "jb" / "checkpoints" / "superPointNet_2_checkpoint.pth.tar"
    sd = torch.load(sp_path, weights_only=True)["model_state_dict"]
    assert all(v.dtype == torch.float32 for v in sd.values() if v.is_floating_point())
    assert int(sd["inc.conv.conv.1.num_batches_tracked"]) == 4
    variables, _ = load_reference_checkpoint(str(sp_path), kind="auto")
    np.testing.assert_array_equal(np.asarray(variables["params"]["inc"]["conv0"]["kernel"]),
                                  sd["inc.conv.conv.0.weight"].numpy().transpose(2, 3, 1, 0))
    net = load_superpoint(str(sp_path), dtype=torch.bfloat16)
    assert net.dtype == torch.bfloat16
    assert all(torch.equal(v, sd[k]) for k, v in net.state_dict().items())


def test_bf16_joint_training_with_remat_block(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = cli.main(["train_good", _bf16(_joint_yaml(tmp_path), remat="block"), "r2",
                    "--device", "cpu"])
    assert out["n_iter"] == 2 and np.isfinite(out["loss"]) and out["skipped_update"] == 0.0
    src = tmp_path / "logs" / "r2" / "checkpoints" / "superPointNet_2_checkpoint.pth.tar"
    assert int(torch.load(src, weights_only=True)["model_state_dict"]
               ["inc.conv.conv.1.num_batches_tracked"]) == 4  # once a step, two frames
    stage1 = _bf16(_joint_yaml(tmp_path, train_iter=1, train_SP=False, retrain_SP=False,
                               pretrained_SP=str(src)), remat="block")
    out = cli.main(["train_good", stage1, "r1", "--device", "cpu"])
    assert np.isfinite(out["loss"]) and out["g_sp_norm"] > 0
    before = torch.load(src, weights_only=True)["model_state_dict"]
    after = torch.load(tmp_path / "logs" / "r1" / "checkpoints"
                       / "superPointNet_1_checkpoint.pth.tar", weights_only=True)
    assert all(torch.equal(v, before[k]) for k, v in after["model_state_dict"].items())


TREE_YAML = """
data: {{dataset: kitti_odo_corr, dump_root: '{root}', batch_size: {bs}, good_num: 64,
       image: {{size: [120, 160, 1]}}, preprocessing: {{resize: [120, 160]}}}}
model: {{name: GoodCorresNet_layers_deepF, depth: 2, if_SP: true, if_quality: true,
        mlp_dtype: bfloat16}}
training: {{seed: 0, train_iter: 3, save_interval: 0, learning_rate: 1.0e-4, train: true,
           train_SP: true, tensorboard: false, retrain: true, retrain_SP: true,
           SP_params: {{out_num_points: 200, conf_thresh: 1.0e-3, nms_dist: 4, patch_size: 5,
                       nn_thresh: 1.0}}}}
"""


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One scene of five 120 x 160 PNG frames: four pairs (delta 1)."""
    root = tmp_path_factory.mktemp("sptree")
    seq = SyntheticImageSequence(n_frames=5, image_size=(120, 160), focal=140.0, n_blobs=80,
                                 n_corners=60, seed=4)
    frames = []
    for k, img in enumerate(seq.frames()):
        frames.append(str(root / f"f{k}.png"))
        write_png(frames[-1], np.rint(img * 255).astype(np.uint8))
    net = SuperPointNet().eval()
    dump_sequence_sp(frames, seq.cam2world_poses(), seq.K, str(root / "tree" / "00"), net,
                     out_num_points=200)
    return root / "tree"


def _tree_yaml(tmp_path, root, bs):
    p = tmp_path / f"tree_{bs}.yaml"
    p.write_text(TREE_YAML.format(root=root, bs=bs))
    return str(p)


def test_bf16_joint_training_over_a_dump_tree_takes_the_jax_pairs(tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = _tree_yaml(tmp_path, tree, 2)
    seen, real = [], cli.joint_train_step

    def step(state, batch, *a, **k):
        seen.append(batch["frame_ids"].cpu().numpy().copy())
        return real(state, batch, *a, **k)

    monkeypatch.setattr(cli, "joint_train_step", step)
    out = cli.main(["train_good", path, "tree", "--device", "cpu"])
    assert out["n_iter"] == 3 and np.isfinite(out["loss"])
    jseen = []

    def recorder(*a, **k):
        def fn(state, b, qc, tc):
            jseen.append(np.asarray(b["frame_ids"]).copy())
            return state, {}
        return fn

    monkeypatch.setattr(j_joint, "make_joint_train_step", recorder)
    j_cli.main(["train_good", path, "jtree"])
    assert len(seen) == len(jseen) == 3
    for got, want in zip(seen, jseen):
        np.testing.assert_array_equal(got, want)
    # Two batches a pass: the third step is the second pass's first batch.
    assert not np.array_equal(seen[0], seen[2]) or not np.array_equal(seen[1], seen[2])


def test_an_empty_train_split_raises(tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no batches"):
        cli.main(["train_good", _tree_yaml(tmp_path, tree, 8), "empty", "--device", "cpu"])
