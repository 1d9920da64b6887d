"""Frontend-quality evaluation: epipolar distance of the matches under the
ground-truth F.

Counterpart of `frontend_epidist_eval` in
`deepfepe_tpu/eval/frontend_eval.py` (the reference's evaluation_epiDist
val_feature): run the frontend on both frames, match, and score each match
by the sum of its two one-sided epipolar distances under F_gt, with
optional Gaussian noise on the match positions. The homography metrics of
that module are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..frontend import FrontendParams, get_matches_from_sp
from ..geometry.epipolar import epi_distance

THRESHOLDS = (0.1, 0.5, 1.0, 2.0)


def frontend_epidist_eval(net, imgs_grey: Tuple[torch.Tensor, torch.Tensor], F_gt: torch.Tensor,
                          fp: FrontendParams, noise_std: float = 0.0,
                          generator: Optional[torch.Generator] = None,
                          thresholds=THRESHOLDS) -> Dict[str, np.ndarray]:
    """{'epi_dists' [B, N] (NaN where no match), 'num_matches' [B],
    'ratio@<t>' [B]: the share of a pair's matches within t pixels}.
    Noise (when `noise_std` > 0 and a CPU `generator` is given) is drawn
    on the CPU and moved to the matches' device."""
    with torch.no_grad():
        out = get_matches_from_sp(net, imgs_grey, fp)
        matches = out["matches_xy_ori"]
        if noise_std > 0.0 and generator is not None:
            noise = torch.randn(matches.shape, generator=generator, dtype=matches.dtype)
            matches = matches + noise_std * noise.to(matches.device)
        _, d1, d2 = epi_distance(F_gt, matches[..., :2], matches[..., 2:4], if_homo=False)
        d = d1 + d2
        valid = out["valid"]
        nv = valid.sum(-1)
        res = {"epi_dists": torch.where(valid, d, torch.full_like(d, float("nan"))),
               "num_matches": nv}
        for t in thresholds:
            res[f"ratio@{t}"] = ((d < t) & valid).sum(-1) / torch.clamp(nv, min=1)
    return {k: v.cpu().numpy() for k, v in res.items()}
