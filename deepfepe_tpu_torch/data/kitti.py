"""Two-frame correspondence dataset over a reference-format dump tree.

Counterpart of `deepfepe_tpu/data/kitti.py` (KITTI, ApolloScape, TUM and
EuRoC dumps; the reference's `datasets/kitti_odo_corr.py`). Per scene
directory:

  cam.npy                             [3, 3]    intrinsics (before the resize)
  poses.npy                           [N, 3, 4] gt absolute poses (cam0 frame)
  Rt_cam2_gt.npy                      [4, 4]    cam0 -> cam2 transform
  ij_match_quality_{i}-{j}_good.npy   [M, 4+]   x1 y1 x2 y2 quality...
  ij_match_quality_{i}-{j}_all.npy    [M, 4+]   (with_matches_all)
  ij_idx_{i}-{j}_good_ij.npy, sift_%06d.npy     (with_sift_des)
  X_cam0_%06d.npy, X_cam2_%06d.npy              (with_X)
  %06d.{jpg,png}                                frames (with_imgs)

`get_item` follows the reference's __getitem__: K scaled by the resize
zoom, E and F from the (cam-frame-conjugated) relative pose, crop-or-pad
to `good_num` with the unique count, every quality column kept with col
0 divided by 300, q/t of the inverse relative pose. The numpy draws
(permutations, pad choices) come from one `np.random.RandomState(seed)`
in the JAX package's order, so both packages yield the same pairs; the
virtual points come from this package's `get_virtual_points`. Frames are
read by `utils.image_io` (JPEG through the native decoder, or PNG, each as
`cv2.imread(IMREAD_GRAYSCALE)` reads it) and resized by its cv2-equivalent
area resize.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry.correct import get_virtual_points
from ..utils.image_io import read_grey, resize_area
from .synthetic import _R_to_q_np


def rt_pad_np(Rt: np.ndarray) -> np.ndarray:
    """[3, 4] -> [4, 4] (a [4, 4] passes through)."""
    if Rt.shape == (4, 4):
        return Rt
    return np.vstack([Rt, [0.0, 0.0, 0.0, 1.0]])


def crop_or_pad_choice(in_num: int, out_num: int,
                       rng: Optional[np.random.RandomState] = None,
                       shuffle: bool = True) -> np.ndarray:
    """Fixed-N sampling indices: a random permutation cut to `out_num`, or
    padded with draws with replacement; the first min(in_num, out_num)
    entries are unique."""
    rng = rng or np.random
    choice = rng.permutation(in_num) if shuffle else np.arange(in_num)
    if in_num >= out_num:
        return choice[:out_num]
    pad = rng.choice(choice, out_num - in_num, replace=True)
    return np.concatenate([choice, pad])


def scale_P(P: np.ndarray, sx: float, sy: float) -> np.ndarray:
    """Scale a 3x4 projection for an image resize."""
    out = P.copy()
    out[0] *= sx
    out[1] *= sy
    return out


def load_h5_arr(path) -> np.ndarray:
    """The dataset 'arr' of one payload file of an h5 dump (h5py is
    imported only here)."""
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f["arr"][()])


def save_arr(base, a: np.ndarray, use_h5: bool = False) -> None:
    """Write `<base>.npy`, or `<base>.h5` with one dataset 'arr'."""
    if use_h5:
        import h5py

        with h5py.File(f"{base}.h5", "w") as f:
            f.create_dataset("arr", data=np.asarray(a))
    else:
        np.save(f"{base}.npy", a)


def infer_cam_id(scene_name: str) -> Optional[str]:
    """The camera id that a reference scene name carries ('00_02' -> '02',
    an apollo '...Record001..._5' -> '_5'), or None for other names."""
    if re.fullmatch(r"\d{2}_(00|02)", scene_name):
        return scene_name[-2:]
    if re.fullmatch(r".*[Rr]ecord\d+.*_([15])", scene_name):
        return scene_name[-2:]
    return None


class KittiCorrDataset:
    """Frame pairs (i, i + delta_ij) with matches on disk, in the schema of
    `SyntheticPairs` batches."""

    def __init__(self, dump_root: str, scenes: Optional[Sequence[str]] = None,
                 delta_ij: int = 1, good_num: int = 1000,
                 image_size: Tuple[int, int] = (376, 1241),
                 resize: Optional[Tuple[int, int]] = None, cam_id: str = "02", seed: int = 0,
                 virtual_iters: int = 8, with_imgs: bool = False,
                 img_gamma: Optional[float] = None, with_matches_all: bool = False,
                 all_num: int = 2000, with_sift_des: bool = False, use_h5: bool = False,
                 with_X: bool = False, cache_in_memory: bool = False):
        """`with_imgs`: grey frames in [0, 1] (`imgs_grey`), raised to
        `img_gamma` when given. `with_matches_all`: the unfiltered match
        set padded to `all_num`. `with_sift_des`: per-match descriptor
        pairs (`des_good`, also `des`). `use_h5`: payload files are .h5.
        `with_X`: the frames' lidar clouds (ragged, batch size 1 only).
        `cache_in_memory`: keep every payload array read after the first
        (frames are read each time)."""
        self.root = Path(dump_root)
        self.delta_ij = delta_ij
        self.good_num = good_num
        self.image_size = tuple(image_size)
        self.resize = tuple(resize or image_size)
        self.cam_id = cam_id
        self.rng = np.random.RandomState(seed)
        self.virtual_iters = virtual_iters
        self.with_imgs = with_imgs
        self.img_gamma = img_gamma
        self.with_matches_all = with_matches_all
        self.all_num = all_num
        self.with_sift_des = with_sift_des
        self.use_h5 = use_h5
        self.ext = ".h5" if use_h5 else ".npy"
        self.with_X = with_X
        self.cache_in_memory = cache_in_memory
        self._arr_cache: dict = {}
        self.zoom_xy = (self.resize[1] / self.image_size[1], self.resize[0] / self.image_size[0])
        if scenes is None:
            scenes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.samples: List[dict] = []
        self._crawl(scenes)

    def _crawl(self, scenes: Sequence[str]) -> None:
        """Index every frame pair whose good-match file exists."""
        for scene_name in scenes:
            scene = self.root / scene_name
            K = np.load(scene / "cam.npy").astype(np.float32).reshape(3, 3)
            poses = np.load(scene / "poses.npy").astype(np.float32).reshape(-1, 3, 4)
            Rt_cam2_gt = np.load(scene / "Rt_cam2_gt.npy").astype(np.float64)
            # The cam0 -> cam2 conjugation applies to camera '02' only; a
            # reference scene name fixes the camera, any other name keeps
            # the constructor's.
            cam_id = self.cam_id
            inferred = infer_cam_id(scene_name)
            if inferred is not None:
                if inferred != self.cam_id:
                    print(f"# kitti loader: scene '{scene_name}' implies cam_id "
                          f"{inferred!r} (constructor said {self.cam_id!r}); using "
                          f"{inferred!r}", file=sys.stderr)
                cam_id = inferred
            for i in range(len(poses) - self.delta_ij):
                j = i + self.delta_ij
                if not (scene / f"ij_match_quality_{i}-{j}_good{self.ext}").is_file():
                    continue
                rel = np.linalg.inv(rt_pad_np(poses[j])) @ rt_pad_np(poses[i])
                if cam_id == "02":
                    rel = Rt_cam2_gt @ rel @ np.linalg.inv(Rt_cam2_gt)
                self.samples.append(dict(
                    scene=scene, scene_name=scene_name, i=i, j=j, K_ori=K,
                    relative_scene_pose=rel.astype(np.float32),
                    Rt_cam2_gt=Rt_cam2_gt.astype(np.float32)))

    def __len__(self) -> int:
        return len(self.samples)

    def _load_arr(self, base) -> np.ndarray:
        """`<base>.npy` (through the native parser when it built) or
        `<base>.h5`, memoized under `cache_in_memory`."""
        if not self.cache_in_memory:
            return self._load_arr_uncached(base)
        key = str(base)
        if key not in self._arr_cache:
            self._arr_cache[key] = self._load_arr_uncached(base)
        return self._arr_cache[key]

    def _load_arr_uncached(self, base) -> np.ndarray:
        if self.use_h5:
            return load_h5_arr(f"{base}.h5")
        from .native_loader import load_npy

        return load_npy(f"{base}.npy")

    def _scaled_matches(self, base) -> np.ndarray:
        zx, zy = self.zoom_xy
        m = self._load_arr(base).astype(np.float32)
        xy = m[:, :4].copy()
        xy[:, [0, 2]] *= zx
        xy[:, [1, 3]] *= zy
        return m, xy

    def get_item(self, index: int) -> Dict[str, np.ndarray]:
        s = self.samples[index]
        zx, zy = self.zoom_xy
        P = np.concatenate([s["K_ori"], np.zeros((3, 1), np.float32)], 1)
        K = scale_P(P, zx, zy)[:, :3]
        rel = s["relative_scene_pose"].astype(np.float64)
        R, t = rel[:3, :3], rel[:3, 3]
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        E = tx @ R
        K64 = K.astype(np.float64)
        F = np.linalg.inv(K64).T @ E @ np.linalg.inv(K64)
        pair = f"{s['i']}-{s['j']}"

        mq, matches = self._scaled_matches(s["scene"] / f"ij_match_quality_{pair}_good")
        # Every quality column, col 0 divided by 300 (the reference's SIFT
        # scaling); a file of bare coordinates gets a quality of ones.
        quality = (mq[:, 4:].copy() if mq.shape[1] > 4
                   else np.ones((len(mq), 1), np.float32))
        quality[:, 0] = quality[:, 0] / 300.0
        choice = crop_or_pad_choice(len(matches), self.good_num, self.rng)
        unique_num = min(len(matches), self.good_num)

        rel_inv = np.linalg.inv(rel)
        extra = {}
        if self.with_matches_all:
            _, ma = self._scaled_matches(s["scene"] / f"ij_match_quality_{pair}_all")
            choice_all = crop_or_pad_choice(len(ma), self.all_num, self.rng)
            extra["matches_all"] = ma[choice_all]
            extra["matches_all_unique_nums"] = np.int32(np.unique(ma, axis=0).shape[0])
        if self.with_sift_des:
            # Reference trees name the index file ..._good_ij; older dumps
            # ..._good.
            stem = s["scene"] / f"ij_idx_{pair}"
            for cand in (f"{stem}_good_ij", f"{stem}_good"):
                if Path(cand + self.ext).exists():
                    idx = self._load_arr(cand)
                    break
            else:
                raise FileNotFoundError(f"{stem}_good_ij{self.ext}")
            s1 = self._load_arr(s["scene"] / f"sift_{s['i']:06d}")
            s2 = self._load_arr(s["scene"] / f"sift_{s['j']:06d}")
            des = np.concatenate([s1[idx[:, 0], 2:], s2[idx[:, 1], 2:]], 1).astype(np.float32)
            extra["des_good"] = des[choice]  # the matches' pad choice
            extra["des"] = extra["des_good"]
        if self.with_X:
            for cam in ("cam0", "cam2"):
                extra[f"X_{cam}s"] = [
                    self._load_arr(s["scene"] / f"X_{cam}_{f:06d}").astype(np.float32)
                    for f in (s["i"], s["j"])]
        if self.with_imgs:
            extra["imgs_grey"] = np.stack([self._load_grey(s["scene"], s["i"]),
                                           self._load_grey(s["scene"], s["j"])])
        return {
            **extra,
            "matches_xy_ori": matches[choice],
            "quality": quality[choice],
            "Ks": K.astype(np.float32),
            "K_invs": np.linalg.inv(K64).astype(np.float32),
            "E_gts": E.astype(np.float32),
            "F_gts": (F / (np.linalg.norm(F) + 1e-20)).astype(np.float32),
            "q_cam": _R_to_q_np(rel_inv[:3, :3]).astype(np.float32),
            "t_cam": rel_inv[:3, 3].astype(np.float32),
            "q_scene": _R_to_q_np(rel[:3, :3]).astype(np.float32),
            "t_scene": rel[:3, 3].astype(np.float32),
            "frame_ids": np.array([s["i"], s["j"]], np.int32),
            "delta_Rtijs_4_4": rel.astype(np.float32),
            "matches_good_unique_nums": np.int32(unique_num),
            "t_scene_scale": np.float32(np.linalg.norm(t)),
            "Rt_cam2_gt": s["Rt_cam2_gt"],
        }

    def _load_grey(self, scene: Path, frame: int) -> np.ndarray:
        """Frame `%06d.{jpg,png}` resized to `resize` (cv2's area resize),
        grey in [0, 1], raised to `img_gamma` when given."""
        for ext in ("jpg", "png"):
            f = scene / f"{frame:06d}.{ext}"
            if f.exists():
                break
        else:
            raise FileNotFoundError(f"{scene}/{frame:06d}.(jpg|png)")
        img = read_grey(f)
        if img.shape[:2] != self.resize:
            img = resize_area(img, self.resize)
        img = img.astype(np.float32) / 255.0
        if self.img_gamma is not None:
            img = img ** np.float32(self.img_gamma)
        return img

    def _virtual(self, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        p1v, p2v = get_virtual_points(torch.from_numpy(out["F_gts"]), self.resize,
                                      iters=self.virtual_iters)
        out["pts1_virt"] = p1v.numpy().astype(np.float32)
        out["pts2_virt"] = p2v.numpy().astype(np.float32)
        return out

    def batches(self, batch_size: int, shuffle: bool = True, drop_last: bool = True
                ) -> Iterator[Dict[str, np.ndarray]]:
        """One pass over the pairs (shuffled by the dataset's RandomState);
        a short last batch is dropped unless `drop_last` is false."""
        order = (self.rng.permutation(len(self.samples)) if shuffle
                 else np.arange(len(self.samples)))
        ragged = {"X_cam0s", "X_cam2s"}
        for start in range(0, len(order), batch_size):
            idxs = order[start:start + batch_size]
            if len(idxs) < batch_size and drop_last:
                return
            items = [self.get_item(int(i)) for i in idxs]
            if self.with_X and batch_size != 1:
                raise ValueError("with_X point clouds are ragged; use batch_size=1")
            out = {k: np.stack([it[k] for it in items]) for k in items[0] if k not in ragged}
            for k in ragged & set(items[0]):
                out[k] = items[0][k]  # batch size 1: the raw list of [Ni, 3]
            yield self._virtual(out)

    def ordered_pair_batches(self, batch_size: int, scene_name: Optional[str] = None
                             ) -> Iterator[Dict[str, np.ndarray]]:
        """Frame-ordered pair batches of one scene (or all) for VO eval; the
        last batch is padded by repeating its final pair, and each item
        carries 'frame_i'."""
        idxs = [k for k, s in enumerate(self.samples)
                if scene_name is None or s["scene_name"] == scene_name]
        idxs.sort(key=lambda k: self.samples[k]["i"])
        for start in range(0, len(idxs), batch_size):
            chunk = idxs[start:start + batch_size]
            items = [self.get_item(k) for k in chunk]
            for it, k in zip(items, chunk):
                it["frame_i"] = np.int32(self.samples[k]["i"])
            while len(items) < batch_size:
                items.append(items[-1])
            yield self._virtual({k: np.stack([it[k] for it in items]) for k in items[0]})
