"""Port parity for bundle adjustment and pose-graph fusion: `geometry/lie.py`,
the rest of `geometry/rotations.py`, `ba/` (the Schur and square-root BA
steps, the synthetic SfM problem, the pose graph, dense and CG) and
`tools/bench_ba.py`, against the JAX package on the same numpy inputs.

Bars: the closed forms (lie, rotations, the synthetic problem, the BA
blocks) agree in float64 to 1e-10 (the problem's draws exactly); a BA or
pose-graph step in float64 to 1e-9 (a few LU or QR solves apart); the
square-root step against the Schur step at tests/test_ba.py's bars (poses
1e-8, points 1e-7, cost 1e-8); the CG step against the dense step at
test_ba.py's 5e-6; a float32 two-stage solve against the JAX package's
(which runs its dense steps in float64 here: x64 is on in
tests/conftest.py) to 5e-5. The JAX pose-graph steps are jitted here (the
package runs them eagerly, ~1.5 s a step on the CPU); the numbers are the
same computation.
"""

import numpy as np
import pytest
import torch
from torch.func import jacfwd

import jax
import jax.numpy as jnp

from conftest import random_pose
from deepfepe_tpu import ba as jba
from deepfepe_tpu.ba import pose_graph as jpg
from deepfepe_tpu.geometry import lie as jlie
from deepfepe_tpu.geometry import rotations as jrot
from deepfepe_tpu_torch import ba
from deepfepe_tpu_torch.ba import bundle_adjustment, pose_graph
from deepfepe_tpu_torch.geometry import lie, rotations
from deepfepe_tpu_torch.utils.device import no_tf32
from _torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-10


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _jprob(p, dtype=jnp.float64):
    return jba.BAProblem(*[jnp.asarray(x.numpy(), dtype) for x in p])


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().numpy() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=atol, rtol=rtol)


# --- geometry/lie.py and rotations -----------------------------------------


@pytest.mark.parametrize("name", ["so3_exp", "_so3_left_jacobian", "se3_exp", "so3_log",
                                  "se3_log"])
def test_lie_maps_match_jax(name, rng):
    if name in ("so3_log", "se3_log"):
        x = lie.se3_exp(_t(rng.randn(40, 6) * 0.7))
        x = x[:, :3, :3] if name == "so3_log" else x
    else:
        x = _t(rng.randn(40, 6 if name == "se3_exp" else 3) * 0.7)
    _close(getattr(lie, name)(x), getattr(jlie, name)(jnp.asarray(x.numpy())), TOL)


def test_lie_round_trips_and_their_small_and_large_angles(rng):
    w = _t(rng.randn(32, 3) * 0.8, torch.float32)
    _close(lie.so3_log(lie.so3_exp(w)), w.numpy(), 1e-4)  # test_ba.py's float32 bar
    xi = _t(rng.randn(16, 6) * 0.5, torch.float32)
    T = lie.se3_exp(xi)
    _close(lie.se3_log(T), xi.numpy(), 1e-4)
    _close(T[:, :3, :3].transpose(-1, -2) @ T[:, :3, :3], np.tile(np.eye(3), (16, 1, 1)), 1e-5)
    # θ ≈ 0: the series branches, exact to float64 rounding, and finite
    # derivatives at 0 (torch.where keeps both branches' tangents finite).
    for s in (0.0, 1e-9, 1e-5):
        xi = _t(rng.randn(6) * s)
        _close(lie.se3_log(lie.se3_exp(xi)), xi.numpy(), 1e-12)
    for fn, x in ((lie.se3_exp, torch.zeros(6, dtype=torch.float64)),
                  (lie.se3_log, torch.eye(4, dtype=torch.float64)),
                  (lie.so3_log, torch.eye(3, dtype=torch.float64))):
        J = jacfwd(fn)(x)
        assert torch.isfinite(J).all()
    _close(jacfwd(lie.so3_log)(torch.eye(3, dtype=torch.float64)),
           np.asarray(jax.jacfwd(jlie.so3_log)(jnp.eye(3))), TOL)
    # θ ≈ π: the clamped arccos branch, as the JAX package computes it. The
    # clamp at -1 + 1e-7 (and the 1e-8 added to 2 sin θ) makes the map
    # accurate only up to θ ≈ π - 5e-4 (the domain is θ < π); closer to π
    # both packages return the same shorter vector.
    axis = rng.randn(5, 3)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    for th in (3.0, np.pi - 1e-2, np.pi - 1e-4):
        R = lie.so3_exp(_t(axis * th))
        got = lie.so3_log(R)
        _close(got, jlie.so3_log(jnp.asarray(R.numpy())), 1e-9)
        if th < np.pi - 1e-3:
            _close(got, axis * th, 1e-3)


def test_rotations_q_to_R_qmul_l2_error_match_jax(rng):
    q = rng.randn(20, 4)
    r = rng.randn(20, 4)
    _close(rotations.q_to_R(_t(q)), jrot.q_to_R(jnp.asarray(q)), TOL)
    _close(rotations.qmul(_t(q), _t(r)), jrot.qmul(jnp.asarray(q), jnp.asarray(r)), TOL)
    _close(rotations.l2_error(_t(q[:, :3]), _t(r[:, :3])),
           jrot.l2_error(jnp.asarray(q[:, :3]), jnp.asarray(r[:, :3])), TOL)
    # q_to_R inverts R_to_q on unit quaternions with w >= 0.
    Rs = rotations.q_to_R(_t(q))
    _close(rotations.q_to_R(rotations.R_to_q(Rs)), Rs.numpy(), 1e-12)


# --- BA ---------------------------------------------------------------------


def _ba_problem(rng, C=4, P=48, perturb=0.2):
    """tests/test_ba.py's `_make_ba_problem`: a few cameras around points at
    8-20 m, noise-free observations, perturbed poses and points; float64."""
    f = 300.0
    K = np.array([[f, 0, 160.0], [0, f, 120.0], [0, 0, 1.0]])
    X = np.stack([rng.uniform(-5, 5, P), rng.uniform(-3, 3, P), rng.uniform(8, 20, P)], -1)
    poses = [np.eye(4)]
    for _ in range(C - 1):
        R, t = random_pose(rng, max_angle_deg=5, t_scale=0.5)
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        poses.append(T @ poses[-1])
    poses = np.stack(poses)
    obs = np.stack([((X @ p[:3, :3].T + p[:3, 3]) / (X @ p[:3, :3].T + p[:3, 3])[:, 2:])
                    @ K.T for p in poses])[..., :2]
    init = poses.copy()
    for c in range(1, C):
        init[c] = lie.se3_exp(_t(rng.randn(6) * perturb * 0.1)).numpy() @ init[c]
    return ba.BAProblem(poses=_t(init), points=_t(X + rng.randn(P, 3) * perturb),
                        obs=_t(obs), vis=_t((rng.rand(C, P) > 0.2).astype(np.float64)), K=_t(K))


def test_sfm_problem_matches_jax():
    got = ba.make_sfm_problem(np.random.RandomState(3), C=6, P=300, window=4)
    want = jba.make_sfm_problem(np.random.RandomState(3), C=6, P=300, window=4)
    for g, w in zip(got[0], want[0]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=1e-12, rtol=0)


def test_jacobians_match_autodiff(rng):
    """The analytic J_cam and J_pt against `torch.func.jacfwd` of the
    residuals in the cameras' left twists and the points (float64)."""
    p = _ba_problem(rng, C=3, P=16, perturb=0.1)
    C, P = p.obs.shape[:2]
    _, Xc = bundle_adjustment.reprojection_residuals(p)
    J_cam, J_pt = bundle_adjustment._jacobians(p, Xc)

    def residual(x):
        poses = lie.se3_exp(x[:C * 6].reshape(C, 6)) @ p.poses
        return bundle_adjustment.reprojection_residuals(
            p._replace(poses=poses, points=p.points + x[C * 6:].reshape(P, 3)))[0]

    J = jacfwd(residual)(torch.zeros(C * 6 + P * 3, dtype=torch.float64))  # [C, P, 2, n]
    for c in range(C):
        _close(J_cam[c], J[c, :, :, c * 6:c * 6 + 6].numpy(), 1e-8, 1e-8)
    J_pt_ad = J[..., C * 6:].reshape(C, P, 2, P, 3)
    _close(J_pt, J_pt_ad[:, torch.arange(P), :, torch.arange(P)].permute(1, 0, 2, 3).numpy(),
           1e-8, 1e-8)
    got = ba.build_normal_blocks(p)
    want = jba.build_normal_blocks(_jprob(p))
    for g, w in zip(got, want):
        _close(g, w, 1e-9, 1e-10)


def test_schur_and_sqrt_steps_match_jax_and_each_other(rng):
    p = _ba_problem(rng)
    jp = _jprob(p)
    schur, info_s = ba.ba_step(p, damping=1e-3)
    j_schur, j_info_s = jba.ba_step(jp, damping=1e-3)
    _close(schur.poses, j_schur.poses, 1e-9)
    _close(schur.points, j_schur.points, 1e-9)
    _close(info_s["new_cost"], j_info_s["new_cost"], 1e-9, 1e-12)
    sq, info_q = ba.sqrt_ba_step(p, damping=1e-3)
    j_sq, j_info_q = jba.sqrt_ba_step(jp, damping=1e-3)
    _close(sq.poses, j_sq.poses, 1e-9)
    _close(sq.points, j_sq.points, 1e-9)
    # test_ba.py's bars for the two steps of one Levenberg system.
    assert bool(info_s["accepted"]) and bool(info_q["accepted"])
    _close(sq.poses, schur.poses.numpy(), 1e-8)
    _close(sq.points, schur.points.numpy(), 1e-7)
    assert abs(float(info_q["new_cost"]) - float(info_s["new_cost"])) < 1e-8
    # A translation-only dof mask leaves every rotation where it was.
    dof = torch.tensor([[1.0, 1, 1, 0, 0, 0]] * 4, dtype=torch.float64)
    frozen, _ = ba.sqrt_ba_step(p, damping=1e-3, dof_mask=dof)
    j_frozen, _ = jba.sqrt_ba_step(jp, damping=1e-3, dof_mask=jnp.asarray(dof.numpy()))
    _close(frozen.poses, j_frozen.poses, 1e-9)
    _close(frozen.poses[:, :3, :3], p.poses[:, :3, :3].numpy(), 1e-12)


def test_batched_problems_step_as_each_alone(rng):
    probs = [_ba_problem(rng, C=3, P=20) for _ in range(3)]
    stacked = ba.BAProblem(*[torch.stack(x) for x in zip(*probs)])
    for step in (ba.ba_step, ba.sqrt_ba_step):
        out, info = step(stacked, damping=1e-3)
        for b, p in enumerate(probs):
            one, one_info = step(p, damping=1e-3)
            _close(out.poses[b], one.poses.numpy(), 1e-10)
            _close(out.points[b], one.points.numpy(), 1e-10)
            assert bool(info["accepted"][b]) == bool(one_info["accepted"])


def test_ba_converges_in_float32():
    """Both steps on the benchmark's problem in float32: the cost falls by
    more than 20x in 15 steps, and the square-root step's optimum is the
    float64 Schur optimum's cost within 1.5x (test_ba.py's bar)."""
    prob = ba.make_sfm_problem(np.random.RandomState(0), C=8, P=300, window=4)[0]
    costs = {}
    for name, opt in (("schur", ba.optimize_ba), ("sqrt", ba.optimize_sqrt_ba)):
        out, c = opt(prob, iters=15, damping=1e-3)
        assert out.points.dtype == torch.float32
        costs[name] = float(bundle_adjustment.reprojection_cost(out))
        assert costs[name] < 0.05 * float(c[0]), (name, c)
    ref, _ = ba.optimize_ba(ba.BAProblem(*[x.double() for x in prob]), iters=15, damping=1e-3)
    assert costs["sqrt"] <= 1.5 * float(bundle_adjustment.reprojection_cost(ref)) + 1e-6


def test_no_tf32_scope():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    seen = []
    try:
        real = bundle_adjustment.build_normal_blocks

        def spy(p):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
            return real(p)

        bundle_adjustment.build_normal_blocks = spy
        ba.ba_step(ba.make_sfm_problem(np.random.RandomState(0), C=3, P=20, window=3)[0])
        with no_tf32():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert seen and all(s == (False, False) for s in seen)
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        bundle_adjustment.build_normal_blocks = real
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# --- the pose graph -----------------------------------------------------------


def _chain(rng, N, dtype=np.float64, skip=True):
    """A 1 m/frame chain with noisy odometry and (i, i + 2) skip edges: the
    numpy relative poses and skip edges."""
    gt = [np.eye(4)]
    for _ in range(N - 1):
        T = np.eye(4)
        T[:3, 3] = [0.1, 0, -1.0]
        gt.append(T @ gt[-1])
    gt = np.stack(gt)
    noise = lambda s: lie.se3_exp(_t(rng.randn(6) * s)).numpy()  # noqa: E731
    rels = np.stack([noise(0.01) @ gt[i + 1] @ np.linalg.inv(gt[i]) for i in range(N - 1)])
    rels2 = np.stack([noise(0.008) @ gt[i + 2] @ np.linalg.inv(gt[i]) for i in range(N - 2)])
    edges = np.stack([np.arange(N - 2), np.arange(2, N)], -1)
    return rels.astype(dtype), rels2.astype(dtype), edges, gt


def _graphs(rels, rels2, edges, odo_w, loop_w):
    tg = ba.graph_from_odometry(torch.from_numpy(rels), loop_edges=torch.from_numpy(edges),
                                loop_measurements=torch.from_numpy(rels2),
                                odo_weight=odo_w, loop_weight=loop_w)
    jg = jba.graph_from_odometry(jnp.asarray(rels), loop_edges=jnp.asarray(edges, jnp.int32),
                                 loop_measurements=jnp.asarray(rels2),
                                 odo_weight=jnp.asarray(odo_w), loop_weight=jnp.asarray(loop_w))
    return tg, jg


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's pose-graph steps, jitted once for the module."""
    return {
        "dense": jax.jit(jpg.gauss_newton_step, static_argnames=("damping", "huber_delta")),
        "cg": jax.jit(jpg.gauss_newton_step_cg,
                      static_argnames=("damping", "huber_delta", "cg_iters")),
    }


@pytest.mark.parametrize("dof,huber", [(None, None), ((1, 1, 1, 0, 0, 0), 0.02),
                                       ((0, 0, 0, 1, 1, 1), None)])
def test_pose_graph_steps_match_jax(dof, huber, rng, jax_steps):
    """One dense and one CG step (float64, per-component weights, gauge and
    dof masks, with and without the Huber IRLS) against the JAX steps; the
    CG step against the dense one (test_ba.py's bar); frozen DoF still."""
    rels, rels2, edges, _ = _chain(rng, 12)
    tg, jg = _graphs(rels, rels2, edges, [1.0, 1.0, 1.0, 2.0, 2.0, 2.0], 0.5)
    for a, b in zip(tg, jg):
        _close(a, b, 1e-12)
    jd = None if dof is None else jnp.asarray(dof)
    gd, ed = ba.gauss_newton_step(tg, damping=1e-6, huber_delta=huber, dof_mask=dof)
    j_gd, j_ed = jax_steps["dense"](jg, damping=1e-6, huber_delta=huber, dof_mask=jd)
    _close(gd.poses, j_gd.poses, 1e-9)
    _close(ed, j_ed, 1e-15, 1e-9)
    gc, ec = ba.gauss_newton_step_cg(tg, damping=1e-6, huber_delta=huber, dof_mask=dof,
                                     cg_iters=400)
    j_gc, _ = jax_steps["cg"](jg, damping=1e-6, huber_delta=huber, dof_mask=jd, cg_iters=400)
    _close(gc.poses, j_gc.poses, 1e-9)
    _close(gc.poses, gd.poses.numpy(), 5e-6)
    _close(ec, ed.numpy(), 0, 1e-10)
    _close(gc.poses[0], tg.poses[0].numpy(), 1e-12)  # the gauge
    if dof is not None:
        frozen = (slice(None), slice(0, 3), slice(0, 3)) if dof[3] == 0 else \
            (slice(None), slice(0, 3), 3)
        if dof[3] == 0:
            _close(gd.poses[frozen], tg.poses[frozen].numpy(), 1e-12)
            _close(gc.poses[frozen], tg.poses[frozen].numpy(), 1e-12)


def test_two_stage_matches_jax_in_float32(rng, jax_steps, monkeypatch):
    """The eval_vo fusion as the CLI builds it (float32, skip edges
    weighted on translation only, Huber 0.05), 3 + 3 steps, against the
    JAX solve; the rotations stay the chained ones."""
    monkeypatch.setattr(jpg, "gauss_newton_step", jax_steps["dense"])
    rels, rels2, edges, _ = _chain(rng, 10, np.float32)
    w = [1.0, 1.0, 1.0, 0.0, 0.0, 0.0]
    tg, jg = _graphs(rels, rels2, edges, 1.0, w)
    got, errs = ba.optimize_pose_graph_two_stage(tg, rot_iters=3, trans_iters=3,
                                                 huber_delta=0.05)
    want, j_errs = jpg.optimize_pose_graph_two_stage(jg, rot_iters=3, trans_iters=3,
                                                     huber_delta=0.05)
    assert got.poses.dtype == torch.float32
    _close(got.poses, want.poses, 5e-5)
    _close(errs, j_errs, 1e-9, 1e-3)
    _close(got.poses[:, :3, :3], tg.poses[:, :3, :3].numpy(), 5e-6)


def test_two_stage_preserves_rotations_where_joint_bends_them(rng):
    """tests/test_ba.py's regression, on the port: skip edges with exact
    translations and corrupted rotations (rotation weight 0). The two-stage
    solve keeps the rotations at least as well as the joint 6-DoF solve and
    still improves the translations over the drifting chain."""
    gt, rels = [np.eye(4)], []
    for _ in range(9):
        R, t = random_pose(rng, max_angle_deg=10, t_scale=1.0)
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        rels.append(T)
        gt.append(T @ gt[-1])
    gt, rels = np.stack(gt), np.stack(rels)
    noisy = rels.copy()
    noisy[:, :3, 3] += rng.randn(len(rels), 3) * 0.08
    skip = []
    for i in range(len(gt) - 2):
        T = gt[i + 2] @ np.linalg.inv(gt[i])
        T[:3, :3] = lie.so3_exp(_t(rng.randn(3) * 0.3)).numpy() @ T[:3, :3]
        skip.append(T)
    graph = ba.graph_from_odometry(
        _t(noisy, torch.float32),
        loop_edges=torch.from_numpy(np.stack([np.arange(8), np.arange(2, 10)], -1)),
        loop_measurements=_t(np.stack(skip), torch.float32),
        loop_weight=torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0]))
    joint, _ = ba.optimize_pose_graph(graph, iters=10)
    staged, _ = ba.optimize_pose_graph_two_stage(graph, rot_iters=10, trans_iters=10)

    def rot_err(poses):
        d = poses[:, :3, :3].double().numpy() @ gt[:, :3, :3].transpose(0, 2, 1)
        return float(np.mean(np.degrees(np.arccos(np.clip(
            (np.trace(d, axis1=1, axis2=2) - 1) / 2, -1, 1)))))

    def trans_err(poses):
        return float(np.mean(np.linalg.norm(poses[:, :3, 3].double().numpy() - gt[:, :3, 3],
                                            axis=1)))

    assert rot_err(staged.poses) <= rot_err(joint.poses) + 1e-6
    assert trans_err(staged.poses) < trans_err(graph.poses)


def test_optimize_pose_graph_solver_choice(rng):
    rels, rels2, edges, _ = _chain(rng, 8)
    tg, _ = _graphs(rels, rels2, edges, 1.0, 1.0)
    dense, e_d = ba.optimize_pose_graph(tg, iters=2, solver="dense")
    auto, e_a = ba.optimize_pose_graph(tg, iters=2)  # 8 nodes: dense
    cg, e_c = ba.optimize_pose_graph(tg, iters=2, solver="cg", cg_iters=300)
    np.testing.assert_array_equal(auto.poses.numpy(), dense.poses.numpy())
    _close(cg.poses, dense.poses.numpy(), 5e-6)
    with pytest.raises(ValueError, match="solver"):
        ba.optimize_pose_graph(tg, solver="sparse")
    r = pose_graph.edge_residuals(dense.poses, dense.edges, dense.measurements)
    r0 = pose_graph.edge_residuals(tg.poses, tg.edges, tg.measurements)
    assert float((r * r).mean()) < float((r0 * r0).mean())


def test_bench_ba_runs_small_on_the_cpu(capsys):
    from deepfepe_tpu_torch.tools import bench_ba

    rows = bench_ba.main(["--points", "200", "--cams", "6", "--sqrt_cams", "5",
                          "--pg_frames", "20", "--iters", "2", "--device", "cpu"])
    assert [r["solver"] for r in rows] == ["schur_ba", "sqrt_ba", "pose_graph_two_stage"]
    assert all(r["converged"] for r in rows[:2]) and rows[0]["peak_mb"] is None
    assert np.isfinite(rows[2]["ate_vs_gt_m"]) and rows[2]["edges"] == 37
    assert "| schur_ba | 6 | 200 |" in capsys.readouterr().out
