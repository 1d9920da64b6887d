"""Port parity: the dump-tree dataset (`data/kitti.py`) and `data_loader`.

A fake dump tree (`data.synthetic_dump.write_corr_dump`: known poses and
KITTI intrinsics, noisy matches with outliers, two quality columns, the
reference layout) goes through the JAX `KittiCorrDataset` and the port's
with the same arguments and seed:

- every numpy key of every batch is equal bit for bit: `batches` shuffled
  and in order, with `drop_last` both ways, `ordered_pair_batches`,
  `with_matches_all`, `with_sift_des`, `with_X`, `cache_in_memory` and
  `use_h5` (the RandomState draws come in the same order);
- the virtual points, which each package computes with its own
  `get_virtual_points` (float32 Newton steps), within 2e-3 px, the bar of
  the port's existing parity test (tests/test_torch_eval_good.py);
- `with_imgs` with a gamma, on 8-bit grey PNG frames that cv2 writes: the
  JAX side reads and resizes through cv2, the port through
  `utils.image_io`; the grey frames (before the gamma) agree within one
  grey level, and at 376x1241 -> 376x1240 every pixel is exact.
"""

import numpy as np
import pytest

import cv2

from deepfepe_tpu.data.kitti import KittiCorrDataset as JKitti
from deepfepe_tpu.loader import data_loader as j_data_loader
from deepfepe_tpu.train.config import config_from_dict as j_config_from_dict
from deepfepe_tpu_torch.data import kitti as t_kitti
from deepfepe_tpu_torch.data.kitti import KittiCorrDataset as TKitti
from deepfepe_tpu_torch.data.synthetic_dump import write_corr_dump
from deepfepe_tpu_torch.loader import DUMP_DATASETS, data_loader
from deepfepe_tpu_torch.train.config import config_from_dict
from _torch_threads import one_torch_thread  # noqa: F401

VIRT_TOL = 2e-3
SIZE = (376, 1241)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    root = tmp_path_factory.mktemp("dump")
    write_corr_dump(root, scenes=2, frames=6, matches=90, seed=3, with_sift_des=True,
                    with_X=True)
    return root


def both(dump, **kw):
    kw = {"good_num": 64, "image_size": SIZE, "resize": (376, 1240), "seed": 7, **kw}
    return JKitti(str(dump), **kw), TKitti(str(dump), **kw)


def assert_same_batches(ja, ta):
    ja, ta = list(ja), list(ta)
    assert len(ja) == len(ta) > 0
    for jb, tb in zip(ja, ta):
        assert jb.keys() == tb.keys()
        for k in jb:
            if k.endswith("_virt"):
                np.testing.assert_allclose(tb[k], jb[k], atol=VIRT_TOL, rtol=0, err_msg=k)
            elif isinstance(jb[k], list):  # with_X's ragged clouds
                for a, b in zip(jb[k], tb[k]):
                    np.testing.assert_array_equal(b, a, err_msg=k)
            else:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
                assert tb[k].dtype == jb[k].dtype, k
    return ta


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False), (False, True),
                                               (False, False)])
def test_batches_equal_jax(dump, shuffle, drop_last):
    j, t = both(dump)
    assert len(j) == len(t) == 10
    for _ in range(2):  # a second pass draws from the advanced RandomState
        got = assert_same_batches(j.batches(4, shuffle=shuffle, drop_last=drop_last),
                                  t.batches(4, shuffle=shuffle, drop_last=drop_last))
        assert len(got) == (2 if drop_last else 3)


def test_ordered_pair_batches_equal_jax(dump):
    j, t = both(dump)
    for scene in (None, "01"):
        got = assert_same_batches(j.ordered_pair_batches(4, scene), t.ordered_pair_batches(4, scene))
    assert got[-1]["frame_i"].tolist() == [4, 4, 4, 4]  # the padded tail


@pytest.mark.parametrize("kw", [dict(with_matches_all=True, all_num=120),
                                dict(with_sift_des=True),
                                dict(cache_in_memory=True, with_matches_all=True, all_num=50),
                                dict(good_num=200, delta_ij=1, scenes=["01"])],
                         ids=["matches_all", "sift_des", "cache_in_memory", "pad_one_scene"])
def test_extras_equal_jax(dump, kw):
    j, t = both(dump, **kw)
    for _ in range(2):
        got = assert_same_batches(j.batches(2), t.batches(2))
    if kw.get("with_sift_des"):
        assert got[0]["des"].shape == (2, 64, 16)
    if kw.get("good_num") == 200:
        assert (got[0]["matches_good_unique_nums"] == 90).all()


def test_with_x_equal_jax(dump):
    j, t = both(dump, with_X=True)
    got = assert_same_batches(j.batches(1, shuffle=False), t.batches(1, shuffle=False))
    assert len(got[0]["X_cam0s"]) == 2
    with pytest.raises(ValueError, match="ragged"):
        next(t.batches(2))


def test_use_h5_equal_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    write_corr_dump(tmp_path, scenes=1, frames=4, matches=70, seed=5)
    for p in sorted(tmp_path.glob("00/ij_*.npy")):
        with h5py.File(p.with_suffix(".h5"), "w") as f:
            f.create_dataset("arr", data=np.load(p))
        p.unlink()
    j, t = both(tmp_path, use_h5=True)
    assert len(t) == 3
    assert_same_batches(j.batches(2, drop_last=False), t.batches(2, drop_last=False))


def test_with_imgs_gamma_on_png_frames(tmp_path):
    """The frames go through cv2 on the JAX side and image_io here."""
    write_corr_dump(tmp_path, scenes=1, frames=3, matches=70, seed=6)
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:SIZE[0], 0:SIZE[1]]
    for f in range(3):
        img = 127 + 100 * np.sin(xx / (5.0 + f)) * np.cos(yy / 7.0) + rng.randn(*SIZE) * 10
        assert cv2.imwrite(str(tmp_path / "00" / f"{f:06d}.png"), np.clip(img, 0, 255)
                           .astype(np.uint8))
    for resize, gamma in (((376, 1240), 0.8), ((120, 400), None)):
        j, t = both(tmp_path, resize=resize, with_imgs=True, img_gamma=gamma)
        jb, tb = next(j.batches(2, shuffle=False)), next(t.batches(2, shuffle=False))
        for k in jb:
            if k != "imgs_grey" and not k.endswith("_virt"):
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        g = 1.0 if gamma is None else gamma
        levels = np.abs(np.rint(tb["imgs_grey"] ** (1 / g) * 255)
                        - np.rint(jb["imgs_grey"] ** (1 / g) * 255))
        assert tb["imgs_grey"].shape == jb["imgs_grey"].shape == (2, 2) + resize
        assert levels.max() <= 1
        exact = (levels == 0).mean()
        assert exact == 1.0 if resize == (376, 1240) else exact > 0.8, exact


def test_jpeg_frames_raise(tmp_path):
    write_corr_dump(tmp_path, scenes=1, frames=2, matches=70, seed=6)
    (tmp_path / "00" / "000000.jpg").write_bytes(b"\xff\xd8")
    t = TKitti(str(tmp_path), good_num=64, with_imgs=True)
    with pytest.raises(NotImplementedError, match="JPEG"):
        t.get_item(0)


def test_cam_id_is_inferred_from_reference_scene_names():
    assert t_kitti.infer_cam_id("00_02") == "02" and t_kitti.infer_cam_id("09_00") == "00"
    assert t_kitti.infer_cam_id("Road11_Record001_5") == "_5"
    assert t_kitti.infer_cam_id("run_1") is None and t_kitti.infer_cam_id("00") is None


def test_crop_or_pad_choice_equals_jax():
    from deepfepe_tpu.data.kitti import crop_or_pad_choice as j_choice

    for n_in, n_out in ((10, 6), (4, 10), (5, 5)):
        a = j_choice(n_in, n_out, np.random.RandomState(1))
        b = t_kitti.crop_or_pad_choice(n_in, n_out, np.random.RandomState(1))
        np.testing.assert_array_equal(a, b)
    assert sorted(set(b[:5].tolist())) == [0, 1, 2, 3, 4]


def _raw(dataset, dump, **data):
    return {"data": {"dataset": dataset, "dump_root": str(dump), "good_num": 64,
                     "image": {"size": [376, 1241, 3]}, "preprocessing": {"resize": [376, 1240]},
                     **data}, "training": {"seed": 4}}


@pytest.mark.parametrize("dataset", DUMP_DATASETS)
def test_data_loader_builds_the_dump_datasets(dump, dataset):
    raw = _raw(dataset, dump, test_scenes=["01"], with_matches_all=True)
    ds, jds = data_loader(config_from_dict(raw), "test"), j_data_loader(j_config_from_dict(raw),
                                                                      "test")
    assert isinstance(ds, TKitti) and len(ds) == len(jds) == 5
    assert ds.resize == (376, 1240) and ds.with_matches_all and ds.all_num == 2000
    assert_same_batches(jds.batches(2), ds.batches(2))
    assert len(data_loader(config_from_dict(raw), "train")) == 10  # no train_scenes: all


def test_data_loader_rejections(dump):
    for read_what, match in (({"with_sift": False}, "with_sift"), ({"with_qt": False}, "with_qt")):
        raw = _raw("kitti_odo_corr", dump, read_what=read_what)
        with pytest.raises(ValueError, match=match):
            data_loader(config_from_dict(raw))
        with pytest.raises(ValueError, match=match):
            j_data_loader(j_config_from_dict(raw))
    with pytest.raises(ValueError, match="unknown dataset"):
        data_loader(config_from_dict(_raw("nuscenes", dump)))
