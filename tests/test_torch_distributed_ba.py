"""Port parity: `ba/distributed.py`, the landmark- and edge-sharded BA and
pose-graph steps, against the JAX package's `ba/distributed.py` on four of
conftest's eight CPU devices.

One world of four CPU ranks under gloo (`tests/_torch_dist.py`, suite
'ba') runs the port's steps on the same numpy-seeded problems, at
tests/test_ba.py's bars:

- the Schur step (3 cameras, 64 points): cost rtol 1e-5, poses atol 5e-4,
  points rtol 2e-3 / atol 2e-2, against the JAX distributed step and the
  port's one-device `ba_step`, in float64 (in float32 the normal
  equations of this problem leave each package's poses up to 1e-2 from
  float64, the JAX package's 1.1e-2, the port's 4.4e-3: measured, so the
  packages' float32 steps are no reference for each other); eight float32
  steps cut the cost a hundredfold;
- the square-root step with the TSQR all-gather (float64, 4 cameras, 64
  points): poses atol 1e-9, points atol 1e-8, against the JAX distributed
  step and the port's one-device `sqrt_ba_step`;
- the pose-graph step (7 edges padded to 8, two a rank): poses atol 2e-5,
  cost (the sum of weighted r²) rtol 1e-5, and the two-stage solve: poses
  atol 5e-5, against the JAX distributed functions and the port's
  one-device `gauss_newton_step` and `optimize_pose_graph_two_stage`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfepe_tpu import ba as jba
from deepfepe_tpu.ba.distributed import (make_distributed_pose_graph_step as jpg_step,
                                         make_distributed_sqrt_ba_step as jsqrt_step,
                                         optimize_pose_graph_two_stage_distributed as jpg_two,
                                         pad_pose_graph_edges as jpad)
from deepfepe_tpu.parallel import make_mesh as jmake_mesh
from deepfepe_tpu_torch import ba
from _torch_dist import World, ba_problem, pose_graph_inputs
from _torch_threads import one_torch_thread  # noqa: F401

WORLD = 4


@pytest.fixture(scope="module")
def world():
    return World("ba", WORLD)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def results(world, jmesh, jax_refs):
    return world.result()


@pytest.fixture(scope="module")
def jax_refs(world, jmesh):
    """The JAX package's distributed steps on the same problems."""
    out = {}
    poses, X, obs, vis, K = (jnp.asarray(a, jnp.float64) for a in ba_problem())
    step = jba.make_distributed_ba_step(jmesh, damping=1e-4, fix_cameras=1)
    p, x, c = step(poses, *jba.shard_ba_inputs(jmesh, X, obs, vis), K)
    out["schur"] = (np.asarray(p), np.asarray(x), float(c))
    poses, X, obs, vis, K = (jnp.asarray(a, jnp.float64) for a in ba_problem(seed=1, C=4))
    step = jsqrt_step(jmesh, damping=1e-3)
    p, x, _ = step(poses, *jba.shard_ba_inputs(jmesh, X, obs, vis), K)
    out["sqrt"] = (np.asarray(p), np.asarray(x))
    graph = _jgraph()
    w6 = graph.weights[:, None] * jnp.ones((1, 6), jnp.float32)
    e, m, w = jpad(graph.edges, graph.measurements, w6, WORLD)
    p, c = jpg_step(jmesh, damping=1e-6)(graph.poses, e, m, w, jnp.ones(6))
    p2, _ = jpg_two(jmesh, graph, rot_iters=4, trans_iters=4, damping=1e-6)
    out["pose_graph"] = (np.asarray(p), float(c), np.asarray(p2))
    return out


def _jgraph():
    rels, loop = pose_graph_inputs()
    return jba.graph_from_odometry(jnp.asarray(rels), loop_edges=jnp.asarray([[0, 6]]),
                                   loop_measurements=jnp.asarray(loop)[None], loop_weight=5.0)


def _tgraph():
    rels, loop = pose_graph_inputs()
    return ba.graph_from_odometry(torch.as_tensor(rels), loop_edges=torch.tensor([[0, 6]]),
                                  loop_measurements=torch.as_tensor(loop)[None], loop_weight=5.0)


def _gather_points(results, key):
    return np.concatenate([r[key]["points"] for r in results])


def test_distributed_schur_step_matches_jax(results, jax_refs):
    jp, jx, jc = jax_refs["schur"]
    r = results[0]["schur"]
    np.testing.assert_allclose(r["cost"], jc, rtol=1e-5)
    np.testing.assert_allclose(r["poses"], jp, atol=5e-4)
    np.testing.assert_allclose(_gather_points(results, "schur"), jx, rtol=2e-3, atol=2e-2)
    prob = ba.BAProblem(*(torch.as_tensor(a, dtype=torch.float64) for a in ba_problem()))
    ref, info = ba.ba_step(prob, damping=1e-4, fix_cameras=1)
    assert bool(info["accepted"])
    np.testing.assert_allclose(r["cost"], float(info["cost"]), rtol=1e-5)
    np.testing.assert_allclose(r["poses"], ref.poses.numpy(), atol=5e-4)


def test_distributed_schur_step_converges(results):
    costs = results[0]["schur"]["costs"]
    assert costs[-1] < costs[0] * 1e-2, costs


def test_distributed_sqrt_step_matches_jax(results, jax_refs):
    jp, jx = jax_refs["sqrt"]
    r = results[0]["sqrt"]
    np.testing.assert_allclose(r["poses"], jp, atol=1e-9)
    np.testing.assert_allclose(_gather_points(results, "sqrt"), jx, atol=1e-8)
    prob = ba.BAProblem(*(torch.as_tensor(a, dtype=torch.float64)
                          for a in ba_problem(seed=1, C=4)))
    ref, info = ba.sqrt_ba_step(prob, damping=1e-3)
    assert bool(info["accepted"])
    np.testing.assert_allclose(r["poses"], ref.poses.numpy(), atol=1e-9)
    np.testing.assert_allclose(_gather_points(results, "sqrt"), ref.points.numpy(), atol=1e-8)


def test_distributed_pose_graph_step_matches_jax(results, jax_refs):
    jp, jc, _ = jax_refs["pose_graph"]
    r = results[0]["pose_graph"]
    assert all(x["pose_graph"]["edges_local"] == 2 for x in results)  # 7 edges padded to 8
    np.testing.assert_allclose(r["poses"], jp, atol=2e-5)
    np.testing.assert_allclose(r["cost"], jc, rtol=1e-5)
    graph = _tgraph()
    ref, mean_r2 = ba.gauss_newton_step(graph, damping=1e-6)
    np.testing.assert_allclose(r["poses"], ref.poses.numpy(), atol=2e-5)
    # One device reports the mean weighted r², the distributed step the sum.
    np.testing.assert_allclose(r["cost"], float(mean_r2) * graph.edges.shape[0] * 6, rtol=1e-5)


def test_distributed_pose_graph_two_stage_matches_jax(results, jax_refs):
    r = results[0]["pose_graph"]
    np.testing.assert_allclose(r["two_stage"], jax_refs["pose_graph"][2], atol=5e-5)
    ref, _ = ba.optimize_pose_graph_two_stage(_tgraph(), rot_iters=4, trans_iters=4,
                                              damping=1e-6)
    np.testing.assert_allclose(r["two_stage"], ref.poses.numpy(), atol=5e-5)
    assert r["costs"][-1] < r["costs"][0]
