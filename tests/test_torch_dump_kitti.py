"""Port parity: the dump writers (`data/dump_kitti.py`) and the frame
sequence they take (`SyntheticImageSequence`).

- `SyntheticImageSequence`: frames, poses and trajectories equal to the
  JAX package's bit for bit (the same numpy code and seed); `pair_batches`
  too, the virtual points within 2e-3 px (each package's own
  `get_virtual_points`).
- The raw-KITTI numpy helpers (OXTS poses, calibration files, velodyne
  clouds, the `X_cam*` files) equal bit for bit.
- The SuperPoint dump of four 120x160 frames with the seeded SuperPointNet
  carried across (`superpoint_state_from_flax`): each package writes its
  tree (the JAX side reads the same PNG frames through cv2 and writes them
  back as `.jpg`, the port as `.png`). Every array file is compared:
  `cam`, `poses`, `Rt_cam2_gt` and the set of matched index pairs exactly
  (matches come sorted by distance, and near-equal distances may swap
  places: 12 of 396 index entries of one pair here); keypoints within 1e-4
  px, descriptors within 1e-4 (the frontend's parity bars,
  tests/test_torch_frontend.py) and the match distances sqrt(2 - 2 d1.d2)
  that follow from them within 1e-4 (2.4e-5 seen). The port's
  tree then reads through both packages' loaders with every numpy key
  equal bit for bit and the frames within one grey level.
- `val_feature --config` over such a tree with its frames: the summary
  equals the JAX `frontend_epidist_eval` over the JAX loader's batches of
  the same tree with the same weights (match counts equal, ratios within
  one match).
"""

import numpy as np
import pytest
import torch

import cv2
import jax.numpy as jnp

from deepfepe_tpu.data import dump_kitti as j_dump
from deepfepe_tpu.data.kitti import KittiCorrDataset as JKitti
from deepfepe_tpu.data.synthetic_images import SyntheticImageSequence as JSequence
from deepfepe_tpu.eval.frontend_eval import frontend_epidist_eval as jepidist
from deepfepe_tpu.frontend import FrontendParams as JFrontendParams
from deepfepe_tpu.frontend.superpoint import SuperPointNet as JSuperPointNet
from deepfepe_tpu_torch import cli
from deepfepe_tpu_torch.data import dump_kitti as t_dump
from deepfepe_tpu_torch.data import SyntheticImageSequence
from deepfepe_tpu_torch.data.kitti import KittiCorrDataset as TKitti
from deepfepe_tpu_torch.data.dump_kitti import dump_sequence_sp
from deepfepe_tpu_torch.frontend import SuperPointNet
from deepfepe_tpu_torch.train import config_from_dict
from deepfepe_tpu_torch.utils.image_io import read_png, write_png
from deepfepe_tpu_torch.utils.weights import superpoint_state_from_flax

from test_torch_frontend import flax_variables
from _torch_threads import one_torch_thread  # noqa: F401

SEQ = dict(n_frames=4, image_size=(120, 160), focal=140.0, n_blobs=80, n_corners=60, seed=3)


def test_synthetic_image_sequence_equals_jax():
    a, b = JSequence(**SEQ), SyntheticImageSequence(**SEQ)
    np.testing.assert_array_equal(b.frames(), a.frames())
    np.testing.assert_array_equal(b.cam2world_poses(), a.cam2world_poses())
    np.testing.assert_array_equal(b.gt_trajectory(), a.gt_trajectory())
    ja, tb = list(a.pair_batches(2)), list(b.pair_batches(2))
    assert len(ja) == len(tb) == 2
    for x, y in zip(ja, tb):
        assert x.keys() == y.keys()
        for k in x:
            tol = 2e-3 if k.endswith("_virt") else 0
            np.testing.assert_allclose(y[k], x[k], atol=tol, rtol=0, err_msg=k)
            assert y[k].dtype == x[k].dtype, k
    assert tb[-1]["frame_i"].tolist() == [2, 2]  # the padded tail
    with pytest.raises(ValueError, match="toward a plane"):
        SyntheticImageSequence(n_frames=200, step_length=0.5)


def test_raw_kitti_helpers_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    packets = np.concatenate([49 + rng.rand(5, 1), 8 + rng.rand(5, 1), 100 + rng.rand(5, 1),
                              rng.rand(5, 3) * 0.1], 1)
    np.testing.assert_array_equal(t_dump.oxts_to_poses(packets), j_dump.oxts_to_poses(packets))
    np.testing.assert_array_equal(t_dump.pose_from_oxts_packet(*packets[2], 0.7),
                                  j_dump.pose_from_oxts_packet(*packets[2], 0.7))
    calib = tmp_path / "calib.txt"
    calib.write_text("P0: 1 0 0 0 0 1 0 0 0 0 1 0\nR_rect: 1 0 0 0 1 0 0 0 1\nname: cam\n")
    a, b = j_dump.read_calib_file(str(calib)), t_dump.read_calib_file(str(calib))
    assert a.keys() == b.keys() and b["name"] == "cam"
    np.testing.assert_array_equal(b["P0"], a["P0"])
    velo = rng.randn(200, 4) * 10
    Tr = np.hstack([np.eye(3)[[1, 2, 0]], rng.randn(3, 1)])
    K = np.array([[700.0, 0, 600], [0, 700, 180], [0, 0, 1]])
    Rt2 = np.eye(4)
    Rt2[0, 3] = 0.06
    for kw in ({}, {"Rt_cam2": Rt2, "K": K, "image_hw": (376, 1241)}):
        for x, y in zip(t_dump.velo_to_cam_points(velo[:, :3], Tr, np.eye(3), **kw),
                        j_dump.velo_to_cam_points(velo[:, :3], Tr, np.eye(3), **kw)):
            np.testing.assert_array_equal(x, y)
    assert t_dump.dump_lidar_frames([velo, velo[:50]], Tr, np.eye(3), tmp_path / "t") == 2
    j_dump.dump_lidar_frames([velo, velo[:50]], Tr, np.eye(3), str(tmp_path / "j"))
    for f in sorted((tmp_path / "j").iterdir()):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / f.name), np.load(f))


def test_the_sift_dump_raises():
    with pytest.raises(NotImplementedError, match="SIFT"):
        t_dump.dump_sequence([], np.zeros((0, 3, 4)), np.eye(3), "x")


@pytest.fixture(scope="module")
def sp_dumps(tmp_path_factory):
    """Both packages' SuperPoint dumps of the same four PNG frames."""
    root = tmp_path_factory.mktemp("sp")
    seq = SyntheticImageSequence(**SEQ)
    frames = []
    for k, img in enumerate(seq.frames()):
        frames.append(str(root / f"frame_{k}.png"))
        write_png(frames[-1], np.rint(img * 255).astype(np.uint8))
    jnet = JSuperPointNet()
    v = flax_variables(jnet, (1, 120, 160, 1))
    net = SuperPointNet().eval()
    net.load_state_dict(superpoint_state_from_flax(v), strict=True)
    poses, K = seq.cam2world_poses(), seq.K
    kw = dict(out_num_points=200, delta_ijs=(1, 2))
    j_dump.dump_sequence_sp(frames, poses, K, str(root / "jax" / "00"), v, net=jnet, **kw)
    t_dump.dump_sequence_sp(frames, poses, K, str(root / "torch" / "00"), net, **kw)
    return root, frames


def _by_pair(d, name):
    """A pair file's rows in the order of its match indices (matches come
    sorted by distance, and near-equal distances may swap between the
    packages)."""
    stem = name.replace("ij_match_quality", "ij_idx").replace(".npy", "_ij.npy")
    idx = np.load(d / stem)
    order = np.lexsort((idx[:, 1], idx[:, 0]))
    return np.load(d / name)[order], idx[order]


def test_sp_dump_files_equal_jax(sp_dumps):
    root, frames = sp_dumps
    jdir, tdir = root / "jax" / "00", root / "torch" / "00"
    jfiles = sorted(p.name for p in jdir.glob("*.npy"))
    assert jfiles == sorted(p.name for p in tdir.glob("*.npy"))
    assert len([f for f in jfiles if f.startswith("ij_match_quality")]) == 2 * (3 + 2)
    for name in jfiles:
        a, b = np.load(jdir / name), np.load(tdir / name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name.startswith("sift_"):
            np.testing.assert_allclose(b[:, :2], a[:, :2], atol=1e-4, err_msg=name)
            np.testing.assert_allclose(b[:, 2:], a[:, 2:], atol=1e-4, err_msg=name)
        elif name.startswith("ij_match_quality"):
            (a, ia), (b, ib) = _by_pair(jdir, name), _by_pair(tdir, name)
            np.testing.assert_array_equal(ib, ia, err_msg=name)  # the same match set
            np.testing.assert_allclose(b[:, :4], a[:, :4], atol=1e-4, err_msg=name)
            np.testing.assert_allclose(b[:, 5], a[:, 5], atol=1e-4, err_msg=name)
            np.testing.assert_allclose(b[:, 4], a[:, 4], atol=300 * 1e-4, err_msg=name)
            assert len(a) > 20, name
        elif name.startswith("ij_idx"):
            assert np.abs(np.sort(np.load(jdir / name).view("i4,i4"), 0).view(np.int32)
                          - np.sort(b.view("i4,i4"), 0).view(np.int32)).max() == 0, name
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)
    for k, f in enumerate(frames):  # PNG frames round-trip exactly (JAX's are JPEG)
        np.testing.assert_array_equal(read_png(tdir / f"{k:06d}.png"),
                                      cv2.imread(f, cv2.IMREAD_GRAYSCALE))
        assert (jdir / f"{k:06d}.jpg").exists()


def test_sp_dump_reads_through_both_loaders(sp_dumps):
    root, _ = sp_dumps
    kw = dict(good_num=150, image_size=(120, 160), seed=2, delta_ij=2, with_imgs=True,
              with_sift_des=True)
    j, t = JKitti(str(root / "torch"), **kw), TKitti(str(root / "torch"), **kw)
    assert len(j) == len(t) == 2
    for jb, tb in zip(j.batches(2, drop_last=False), t.batches(2, drop_last=False)):
        assert jb.keys() == tb.keys()
        for k in jb:
            if k == "imgs_grey":
                assert np.abs(tb[k] - jb[k]).max() <= 1 / 255 + 1e-7
            elif not k.endswith("_virt"):
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tb["des"].shape[-1] == 2 * 256


def test_val_feature_config_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seq = SyntheticImageSequence(n_frames=4, image_size=(120, 160), focal=140.0, n_blobs=80,
                                 n_corners=60, seed=4)
    frames = []
    for k, img in enumerate(seq.frames()):
        frames.append(str(tmp_path / f"f{k}.png"))
        write_png(frames[-1], np.rint(img * 255).astype(np.uint8))
    jnet = JSuperPointNet()
    v = flax_variables(jnet, (1, 120, 160, 1))
    net = SuperPointNet().eval()
    net.load_state_dict(superpoint_state_from_flax(v), strict=True)
    dump_sequence_sp(frames, seq.cam2world_poses(), seq.K, str(tmp_path / "tree" / "00"), net,
                     out_num_points=200)
    ckpt = tmp_path / "sp.pth.tar"
    torch.save({"n_iter": 0, "model_state_dict": superpoint_state_from_flax(v)}, ckpt)
    cfg = config_from_dict({"data": {"dataset": "kitti_odo_corr", "batch_size": 2,
                                     "dump_root": str(tmp_path / "tree"), "good_num": 64,
                                     "image": {"size": [120, 160, 1]},
                                     "preprocessing": {"resize": [120, 160]}},
                            "training": {"SP_params": {"out_num_points": 300,
                                                       "conf_thresh": 1e-3}}})
    summary = cli.val_feature("vfc", pretrained=str(ckpt), config=cfg, device="cpu")
    assert summary["pairs"] == 3 and summary["device"] == "cpu"
    jds = JKitti(str(tmp_path / "tree"), good_num=64, image_size=(120, 160), seed=0,
                 with_imgs=True)
    outs = [jepidist(jnet, v, (jnp.asarray(b["imgs_grey"][:, 0]), jnp.asarray(b["imgs_grey"][:, 1])),
                     jnp.asarray(b["F_gts"]), JFrontendParams(out_num_points=300, conf_thresh=1e-3))
            for b in jds.batches(2, shuffle=False, drop_last=False)]
    assert summary["num_matches"] == pytest.approx(
        np.mean([np.mean(np.asarray(o["num_matches"])) for o in outs]), abs=0)
    low = min(np.min(np.asarray(o["num_matches"])) for o in outs)
    for k in ("ratio@0.1", "ratio@0.5", "ratio@1.0", "ratio@2.0"):
        want = np.mean([np.mean(np.asarray(o[k])) for o in outs])
        assert abs(summary[k] - want) <= 1.0 / low, k
    assert summary["ratio@2.0"] > 0.5  # the dump's own geometry
    assert (tmp_path / "logs" / "vfc" / "result_dict_all.npz").exists()
