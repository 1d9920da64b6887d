"""Where the port's float32 Gram sum stands against the JAX package's.

    JAX_PLATFORMS=cpu python tests/_torch_gram_probe.py

Prints, on the CPU:

- for the plain-net batch of tests/_torch_joint_setup.py (DeepFNet depth
  2, F-loss) and for sampled 20-point subsets: the float32 gradient's
  largest relative distance from float64 for the port with the solver's
  Gram summed in float32 and in float64, and for the JAX package
  (tests/test_torch_sample_loss.py asserts the float64 sum against JAX);
- tests/test_torch_eval_good.py's float32 RANSAC-F batches: how far each
  minimal-fit hypothesis' inlier count moves between the JAX package and
  the port when the port sums the minimal fits' Gram in float32 or in
  float64, separately for the draws with and without a repeated index
  (the rank-7 sets), with their share.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (JAX on the CPU, x64 enabled)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_eval_good as eval_test  # noqa: E402
import test_torch_sample_loss as sample_test  # noqa: E402
from deepfepe_tpu.data.synthetic import SyntheticPairs as JSyntheticPairs  # noqa: E402
from deepfepe_tpu.eval import ransac as jransac  # noqa: E402
from deepfepe_tpu_torch.eval import ransac  # noqa: E402
from deepfepe_tpu_torch.geometry.basic import homo  # noqa: E402
from deepfepe_tpu_torch.geometry.epipolar import epi_distance  # noqa: E402
from deepfepe_tpu_torch.ops import fmatrix  # noqa: E402


def gram_sum(accumulate):
    """`smallest_singular_vec_gram` with its sum in `accumulate`, for
    every caller (the solver's fits and RANSAC's minimal fits)."""
    real = fmatrix.smallest_singular_vec_gram

    def patched(X, gap_eps=1e-10, **_):
        return real(X, gap_eps, accumulate=accumulate)

    return patched


def solver_distances(measure):
    """`measure()`'s float32 gradient distances from float64 with the
    solver's Gram summed in float32 and in float64, and the JAX package's."""
    out = {}
    real_fm = fmatrix.smallest_singular_vec_gram
    for name, acc in (("port_float32_sum", torch.float32), ("port_float64_sum", torch.float64)):
        fmatrix.smallest_singular_vec_gram = gram_sum(acc)
        try:
            d = measure()
        finally:
            fmatrix.smallest_singular_vec_gram = real_fm
        out[name] = d["port"]
    out["jax_float32"] = d["jax"]
    return out


def ransac_shifts():
    gen = JSyntheticPairs(image_size=(376, 1241), good_num=eval_test.N, seed=11)
    batches = [gen.batch(eval_test.B) for _ in range(2)]
    rows = []
    for batch, (_, idx) in zip(batches, eval_test._draws(2)):
        m = batch["matches_xy_ori"]
        for i in range(eval_test.B):
            x1, x2 = m[i, :, :2], m[i, :, 2:]
            p1, p2 = jransac.homo(jnp.asarray(x1)), jransac.homo(jnp.asarray(x2))
            Fs = jax.vmap(lambda ii: jransac._fit_minimal(p1, p2, ii))(jnp.asarray(idx[i].numpy()))
            d, _, _ = jransac.epi_distance(Fs[:, None], jnp.asarray(x1)[None],
                                           jnp.asarray(x2)[None], if_homo=False)
            jc = np.asarray((d.reshape(-1, eval_test.N) < 1.0).sum(-1))
            rep = np.array([len(set(r)) < 8 for r in idx[i].numpy()])
            t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
            row = {"repeated_share": float(rep.mean())}
            for name, acc in (("float32", torch.float32), ("float64", torch.float64)):
                real = ransac.smallest_singular_vec_gram
                ransac.smallest_singular_vec_gram = gram_sum(acc)
                try:
                    F = ransac._fit_minimal(homo(t1)[None], homo(t2)[None], idx[i][None].long())[0]
                finally:
                    ransac.smallest_singular_vec_gram = real
                pd, _, _ = epi_distance(F, t1[None], t2[None])
                shift = np.abs((pd < 1.0).sum(-1).numpy() - jc)
                row[f"{name}_sum_max_shift_repeated"] = int(shift[rep].max())
                row[f"{name}_sum_max_shift_distinct"] = int(shift[~rep].max())
            rows.append(row)
    return rows


if __name__ == "__main__":
    inputs = sample_test.plain_net_inputs()
    print("plain-net batch, float32 gradient distance from float64:",
          solver_distances(lambda: sample_test.plain_net_gradient_distances(*inputs)))
    print("sampled 20-point subsets, the same:",
          solver_distances(sample_test.sampled_subset_gradient_distances))
    print(f"RANSAC minimal fits, inlier-count shift against JAX (N = {eval_test.N}, "
          f"bar {0.05 * eval_test.N:.0f}):")
    for row in ransac_shifts():
        print(" ", row)
