"""Pose-graph optimization over SE(3) (batched Gauss-Newton).

Counterpart of `deepfepe_tpu/ba/pose_graph.py`: the downstream fusion of
the two-view pipeline's relative poses. Nodes are keyframe world poses T_i
(world -> frame i, as `eval.vo` chains them); edges are measured relative
transforms T_ij with x_j = T_ij x_i. An edge's residual is
log(T_ij⁻¹ T_j T_i⁻¹) in se(3) (v, w).

Two solvers for the damped normal equations:
- `gauss_newton_step`: the dense [6E, 6N] Jacobian and a dense solve, the
  exact reference for a few hundred nodes;
- `gauss_newton_step_cg`: matrix-free, the per-edge [6, 6] Jacobian blocks
  (mapped over the edges), block-Jacobi preconditioned CG for a fixed
  `cg_iters`; O(E) memory, for 10k-100k-frame graphs.

The JAX package takes its Jacobians in forward mode (`jax.jacfwd`); here
they come from reverse mode (`torch.func.jacrev`), the same matrices to
rounding: PyTorch's forward mode (2.13) carries the tangent of a float32
tensor times a Python float in float64, and the products that follow
refuse the mixed types.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jacrev, vmap

from ..geometry.lie import se3_exp, se3_log
from ..utils.device import no_tf32


class PoseGraph(NamedTuple):
    poses: torch.Tensor         # [N, 4, 4] current world -> frame estimates
    edges: torch.Tensor         # [E, 2] long (i, j)
    measurements: torch.Tensor  # [E, 4, 4] measured T_ij
    weights: torch.Tensor       # [E] or [E, 6] information weights, (v, w)
    #                             per component: an edge contributes only
    #                             what it measures well


def edge_residuals(poses: torch.Tensor, edges: torch.Tensor,
                   measurements: torch.Tensor) -> torch.Tensor:
    """se(3) residuals [E, 6] of every edge."""
    T_rel = poses[edges[:, 1]] @ torch.linalg.inv(poses[edges[:, 0]])
    return se3_log(torch.linalg.inv(measurements) @ T_rel)


def _apply_delta(poses: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update T_i <- exp(δ_i) T_i; δ [N, 6]."""
    return se3_exp(delta) @ poses


def _robust_sqrt_weights(graph: PoseGraph, huber_delta: float | None) -> torch.Tensor:
    """sqrt of the edge weights ([E, 1] or [E, 6]), scaled by the Huber IRLS
    factor min(1, δ/||r||) of each edge's current residual."""
    w = graph.weights
    w = w[:, None] if w.ndim == 1 else w
    if huber_delta is not None:
        rnorm = torch.linalg.vector_norm(
            edge_residuals(graph.poses, graph.edges, graph.measurements), dim=-1)
        w = w * torch.clamp(huber_delta / (rnorm + 1e-12), max=1.0)[:, None]
    return torch.sqrt(w)


@no_tf32()
def gauss_newton_step(graph: PoseGraph, damping: float = 1e-6, fix_first: bool = True,
                      huber_delta: float | None = None, dof_mask=None
                      ) -> Tuple[PoseGraph, torch.Tensor]:
    """One Levenberg-damped Gauss-Newton step; returns (graph, mean r²).

    `huber_delta` down-weights edges with ||r|| > δ by δ/||r|| (IRLS), so a
    few failed measurements cannot bend the whole trajectory. `dof_mask`
    (6 zeros and ones in se(3) order (v, w)) freezes those DoF of every
    node: their rows and columns are zeroed with 1 on the diagonal, so the
    solve leaves them exactly still."""
    N = graph.poses.shape[0]
    dtype, dev = graph.poses.dtype, graph.poses.device
    sqrt_w = _robust_sqrt_weights(graph, huber_delta)

    def residual_of_delta(delta):
        poses = _apply_delta(graph.poses, delta.reshape(N, 6))
        return (edge_residuals(poses, graph.edges, graph.measurements) * sqrt_w).reshape(-1)

    delta0 = torch.zeros(N * 6, dtype=dtype, device=dev)
    r0 = residual_of_delta(delta0)
    J = jacrev(residual_of_delta)(delta0)  # [6E, 6N]
    H = J.T @ J
    g = J.T @ r0
    mask = torch.ones(N * 6, dtype=torch.bool, device=dev)
    if fix_first:  # gauge: the first pose is held
        mask &= torch.arange(N * 6, device=dev) >= 6
    if dof_mask is not None:
        mask &= torch.as_tensor(dof_mask, device=dev).bool().repeat(N)
    m = mask.to(dtype)
    H = H * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    H = H + damping * torch.eye(N * 6, dtype=dtype, device=dev)
    delta = -torch.linalg.solve(H, (g * m)[:, None])[:, 0]
    new_poses = _apply_delta(graph.poses, delta.reshape(N, 6))
    return graph._replace(poses=new_poses), torch.mean(r0 * r0)


def _edge_jacobians(graph: PoseGraph, sqrt_w: torch.Tensor):
    """Each edge's weighted residual r_e(δ_i, δ_j) and its two [6, 6]
    Jacobian blocks, differentiated in 12 local variables and mapped over
    the edges: (r [E, 6], Ji [E, 6, 6], Jj [E, 6, 6])."""
    Ti = graph.poses[graph.edges[:, 0]]
    Tj = graph.poses[graph.edges[:, 1]]
    M = graph.measurements
    sw = sqrt_w.expand(Ti.shape[0], 6)

    def res(di, dj, Ti_e, Tj_e, M_e, sw_e):
        T_rel = (se3_exp(dj) @ Tj_e) @ torch.linalg.inv(se3_exp(di) @ Ti_e)
        return sw_e * se3_log(torch.linalg.inv(M_e) @ T_rel)

    zero = torch.zeros(Ti.shape[0], 6, dtype=Ti.dtype, device=Ti.device)
    r = vmap(res)(zero, zero, Ti, Tj, M, sw)
    Ji = vmap(jacrev(res, argnums=0))(zero, zero, Ti, Tj, M, sw)
    Jj = vmap(jacrev(res, argnums=1))(zero, zero, Ti, Tj, M, sw)
    return r, Ji, Jj


@no_tf32()
def gauss_newton_step_cg(graph: PoseGraph, damping: float = 1e-6, fix_first: bool = True,
                         huber_delta: float | None = None, dof_mask=None,
                         cg_iters: int = 200) -> Tuple[PoseGraph, torch.Tensor]:
    """Matrix-free Gauss-Newton step: H is never formed. Hx = Σ_e J_eᵀ(J_e
    x_e) is two gathers, two batched [6, 6] products and a scatter-add an
    application; block-Jacobi preconditioned CG runs exactly `cg_iters`
    iterations (chain-like graphs have condition ~ N², so it should grow
    with the diameter). Gauge fixing and `dof_mask` are projections inside
    the product and the preconditioner, so frozen DoF get exactly zero."""
    N = graph.poses.shape[0]
    dtype, dev = graph.poses.dtype, graph.poses.device
    r, Ji, Jj = _edge_jacobians(graph, _robust_sqrt_weights(graph, huber_delta))
    ei, ej = graph.edges[:, 0], graph.edges[:, 1]
    eij = torch.cat([ei, ej])

    free = torch.ones(N, 6, dtype=dtype, device=dev)
    if fix_first:
        free[0] = 0.0
    if dof_mask is not None:
        free = free * torch.as_tensor(dof_mask, dtype=dtype, device=dev)[None, :]

    def scatter(vals_i, vals_j):
        vals = torch.cat([vals_i, vals_j])
        return torch.zeros((N,) + vals.shape[1:], dtype=dtype, device=dev).index_add_(0, eij,
                                                                                      vals)

    def matvec(x):  # x [N, 6]
        x = x * free
        y = torch.einsum("eab,eb->ea", Ji, x[ei]) + torch.einsum("eab,eb->ea", Jj, x[ej])
        out = scatter(torch.einsum("eab,ea->eb", Ji, y), torch.einsum("eab,ea->eb", Jj, y))
        return (out + damping * x) * free

    g = scatter(torch.einsum("eab,ea->eb", Ji, r), torch.einsum("eab,ea->eb", Jj, r)) * free
    # Block-Jacobi preconditioner: each node's [6, 6] diagonal block of H;
    # frozen DoF get zero rows and columns with 1 on the diagonal.
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    B = scatter(torch.einsum("eab,eac->ebc", Ji, Ji), torch.einsum("eab,eac->ebc", Jj, Jj))
    B = B + (damping + 1e-12) * eye6
    B = B * (free[:, :, None] * free[:, None, :]) + torch.einsum("nd,de->nde", 1.0 - free, eye6)
    B_inv = torch.linalg.inv(B)

    def precond(x):
        return torch.einsum("nab,nb->na", B_inv, x) * free

    # Preconditioned CG on H δ = -g.
    rr = -g
    z = precond(rr)
    x, p, rz = torch.zeros(N, 6, dtype=dtype, device=dev), z, torch.sum(rr * z)
    for _ in range(cg_iters):
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(denom > 0, rz / (denom + 1e-30), torch.zeros_like(rz))
        x = x + alpha * p
        rr = rr - alpha * Ap
        z = precond(rr)
        rz_new = torch.sum(rr * z)
        beta = torch.where(rz > 0, rz_new / (rz + 1e-30), torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
    new_poses = _apply_delta(graph.poses, x * free)
    return graph._replace(poses=new_poses), torch.mean(r * r)


def optimize_pose_graph(graph: PoseGraph, iters: int = 10, damping: float = 1e-6,
                        huber_delta: float | None = None, dof_mask=None, solver: str = "auto",
                        cg_iters: int = 200) -> Tuple[PoseGraph, torch.Tensor]:
    """`iters` Gauss-Newton steps; returns (graph, mean r² before each).
    solver: 'dense', 'cg' or 'auto' (dense up to 512 nodes)."""
    if solver == "auto":
        solver = "dense" if graph.poses.shape[0] <= 512 else "cg"
    if solver not in ("dense", "cg"):
        raise ValueError(f"solver {solver!r} is not one of ('auto', 'dense', 'cg')")
    errs = []
    for _ in range(iters):
        if solver == "cg":
            graph, e = gauss_newton_step_cg(graph, damping, huber_delta=huber_delta,
                                            dof_mask=dof_mask, cg_iters=cg_iters)
        else:
            graph, e = gauss_newton_step(graph, damping, huber_delta=huber_delta,
                                         dof_mask=dof_mask)
        errs.append(e)
    return graph, torch.stack(errs)


def optimize_pose_graph_two_stage(graph: PoseGraph, rot_iters: int = 10, trans_iters: int = 10,
                                  damping: float = 1e-6, huber_delta: float | None = None,
                                  solver: str = "auto", cg_iters: int = 200
                                  ) -> Tuple[PoseGraph, torch.Tensor]:
    """Rotation averaging, then translation refinement with the rotations
    frozen. Monocular two-view edges measure rotation well and translation
    only up to noise; a joint 6-DoF solve lets skip-edge translation misfit
    bend rotations. So: (1) the SO(3) stage keeps only the ω weights and
    updates only the rotation DoF; (2) the translation stage updates only
    the v DoF with the full weights. Returns (graph, both stages' mean r²)."""
    w = graph.weights
    w6 = w[:, None] * torch.ones(1, 6, dtype=w.dtype, device=w.device) if w.ndim == 1 else w
    rot_only = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 1.0], dtype=w6.dtype, device=w6.device)
    g_rot, errs_r = optimize_pose_graph(
        graph._replace(weights=w6 * rot_only), iters=rot_iters, damping=damping,
        huber_delta=huber_delta, dof_mask=[0, 0, 0, 1, 1, 1], solver=solver, cg_iters=cg_iters)
    g_trans, errs_t = optimize_pose_graph(
        graph._replace(poses=g_rot.poses), iters=trans_iters, damping=damping,
        huber_delta=huber_delta, dof_mask=[1, 1, 1, 0, 0, 0], solver=solver, cg_iters=cg_iters)
    return g_trans, torch.cat([errs_r, errs_t])


def graph_from_odometry(rel_poses: torch.Tensor, loop_edges: torch.Tensor | None = None,
                        loop_measurements: torch.Tensor | None = None, odo_weight=1.0,
                        loop_weight=1.0) -> PoseGraph:
    """A graph from sequential relative poses [N-1, 4, 4] (frame i -> i+1;
    the initial poses chained) and optional loop edges [L, 2] with their
    measurements [L, 4, 4]. Weights are scalars or 6-vectors (v, w)."""
    dtype, dev = rel_poses.dtype, rel_poses.device
    n = rel_poses.shape[0] + 1
    poses = [torch.eye(4, dtype=dtype, device=dev)]
    for k in range(n - 1):
        poses.append(rel_poses[k] @ poses[-1])
    poses = torch.stack(poses)

    def tile_w(w, count):
        w = torch.as_tensor(w, dtype=dtype, device=dev)
        return w.expand(count).clone() if w.ndim == 0 else w[None, :].repeat(count, 1)

    edges = torch.stack([torch.arange(n - 1), torch.arange(1, n)], -1).to(dev)
    meas = rel_poses
    weights = tile_w(odo_weight, n - 1)
    if loop_edges is not None:
        edges = torch.cat([edges, torch.as_tensor(loop_edges, device=dev).long()])
        meas = torch.cat([meas, loop_measurements])
        lw = tile_w(loop_weight, len(loop_edges))
        if weights.ndim != lw.ndim:  # mixed scalar and per-component
            weights = weights[:, None].expand(-1, 6) if weights.ndim == 1 else weights
            lw = lw[:, None].expand(-1, 6) if lw.ndim == 1 else lw
        weights = torch.cat([weights, lw])
    return PoseGraph(poses=poses, edges=edges, measurements=meas, weights=weights)
