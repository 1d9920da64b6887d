"""Nested-dict h5 and gzip-pickle IO.

Counterpart of `deepfepe_tpu/utils/io.py`, a copy of the VCG helpers the
reference vendors twice (`datasets/utils/util.py` :58-110 and
`kitti_tools/utils_good.py`): saveh5/loadh5 (a nested dict of arrays <->
HDF5 groups; h5py is imported on use) and savepklz/loadpklz (gzip pickle).
"""

from __future__ import annotations

import gzip
import pickle
from typing import Any, Dict

import numpy as np


def saveh5(d: Dict[str, Any], path: str) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        _save_group(f, d)


def _save_group(grp, d: Dict[str, Any]) -> None:
    for k, v in d.items():
        if isinstance(v, dict):
            _save_group(grp.create_group(k), v)
        else:
            grp.create_dataset(k, data=np.asarray(v))


def loadh5(path: str) -> Dict[str, Any]:
    import h5py

    with h5py.File(path, "r") as f:
        return _load_group(f)


def _load_group(grp) -> Dict[str, Any]:
    import h5py

    out: Dict[str, Any] = {}
    for k, v in grp.items():
        out[k] = _load_group(v) if isinstance(v, h5py.Group) else v[()]
    return out


def savepklz(obj: Any, path: str) -> None:
    with gzip.open(path, "wb") as f:
        pickle.dump(obj, f)


def loadpklz(path: str) -> Any:
    with gzip.open(path, "rb") as f:
        return pickle.load(f)


def dict_update(d: Dict, u: Dict) -> Dict:
    """Recursive dict merge (ref: utils/tools.py:13)."""
    for k, v in u.items():
        if isinstance(v, dict):
            d[k] = dict_update(d.get(k, {}), v)
        else:
            d[k] = v
    return d
