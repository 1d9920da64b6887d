"""Distributed bundle adjustment and pose-graph steps over the data group.

Counterpart of `deepfepe_tpu/ba/distributed.py`: the landmark axis of BA
and the edge axis of a pose graph are the ones that grow, so each rank of
the mesh's data group holds a shard of them and the small camera system
is assembled with collectives:

- the Schur step: each rank's partial normal blocks and Schur
  contribution, all-reduced; the dense camera solve on every rank; the
  landmark back-substitution local;
- the square-root step: each rank eliminates its landmarks by QR and
  reduces its nullspace rows to one [6C+1, 6C+1] triangular factor of
  [A | b]; the factors are all-gathered (TSQR), stacked with the damping
  rows and factored again, and the triangular pose solve runs on every
  rank;
- the pose graph: each rank's edge residuals and Jacobian (by `jacrev`,
  as `ba/pose_graph.py` takes it), its partial JᵀJ and Jᵀr all-reduced, the
  damped solve on every rank.

Each function takes the global replicated arrays (poses, K, the dof mask)
and this rank's shard (`shard_ba_inputs`, `pad_pose_graph_edges` then
`shard_edges`), and returns the replicated poses (and the local points).
As in the JAX package the steps always apply their update (no acceptance
test). Every solve runs under `utils.device.no_tf32`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.func import jacrev

from ..geometry.lie import se3_exp
from ..parallel.mesh import DATA_AXIS, Mesh, shard, sum_over
from ..utils.device import no_tf32
from .bundle_adjustment import BAProblem, build_normal_blocks
from .pose_graph import PoseGraph, _apply_delta, edge_residuals
from .sqrt_ba import _stacked_jacobians


def shard_ba_inputs(mesh: Mesh, points, obs, vis):
    """This rank's landmarks: points [P/n, 3], obs [C, P/n, 2], vis [C, P/n]
    (P must divide by the data group's size)."""
    return shard(mesh, points, 0), shard(mesh, obs, 1), shard(mesh, vis, 1)


def make_distributed_ba_step(mesh: Mesh, damping: float = 1e-4, fix_cameras: int = 1):
    """step(poses [C, 4, 4], points_l, obs_l, vis_l, K) -> (poses, points_l,
    cost) with the landmarks sharded over the data group (Schur form)."""

    @no_tf32()
    def step(poses, points_l, obs_l, vis_l, K):
        C = poses.shape[0]
        dtype, dev = points_l.dtype, points_l.device
        H_cc, H_pp, W, b_c, b_p, cost = build_normal_blocks(
            BAProblem(poses, points_l, obs_l, vis_l, K))
        Hpp_inv = torch.linalg.inv(H_pp + damping * torch.eye(3, dtype=dtype, device=dev))
        WH = torch.einsum("cpij,pjk->cpik", W, Hpp_inv)
        S_part = -torch.einsum("apik,bpjk->abij", WH, W)
        g_part = b_c - torch.einsum("cpik,pk->ci", WH, b_p)
        H_cc, S, g, cost = sum_over(mesh.data_group, H_cc, S_part, g_part, cost)
        eyeC = torch.eye(C, dtype=dtype, device=dev)
        S = S + torch.einsum("cij,cd->cdij", H_cc + damping * torch.eye(6, dtype=dtype,
                                                                         device=dev), eyeC)
        S_full = S.transpose(1, 2).reshape(C * 6, C * 6)
        mask = (torch.arange(C * 6, device=dev) >= fix_cameras * 6).to(dtype)
        S_full = S_full * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        delta_c = -torch.linalg.solve(S_full, (g.reshape(C * 6) * mask)[:, None])[:, 0]
        delta_c = delta_c.reshape(C, 6)
        Wt_dc = torch.einsum("cpij,ci->pj", W, delta_c)
        delta_p = -torch.einsum("pij,pj->pi", Hpp_inv, b_p + Wt_dc)
        return se3_exp(delta_c) @ poses, points_l + delta_p, cost

    return step


def make_distributed_sqrt_ba_step(mesh: Mesh, damping: float = 1e-4, fix_cameras: int = 1):
    """step(poses, points_l, obs_l, vis_l, K) -> (poses, points_l, cost):
    the square-root step with the landmark shards combined by TSQR."""

    @no_tf32()
    def step(poses, points_l, obs_l, vis_l, K):
        C = poses.shape[0]
        dtype, dev = points_l.dtype, points_l.device
        sqrt_l = torch.sqrt(torch.tensor(damping, dtype=dtype, device=dev))
        free = (torch.arange(6 * C, device=dev) >= 6 * fix_cameras).to(dtype)
        r_l, J_l, J_p, cost = _stacked_jacobians(BAProblem(poses, points_l, obs_l, vis_l, K))
        Pl = points_l.shape[0]
        J_l_aug = torch.cat([J_l, (sqrt_l * torch.eye(3, dtype=dtype, device=dev))
                             .expand(Pl, 3, 3)], dim=1)
        J_p_aug = torch.cat([J_p, J_p.new_zeros(Pl, 3, 6 * C)], dim=1)
        r_aug = torch.cat([r_l, r_l.new_zeros(Pl, 3)], dim=1)
        Q, R_full = torch.linalg.qr(J_l_aug, mode="complete")
        R_land = R_full[:, :3, :]
        Jp_rot = torch.einsum("pmi,pmk->pik", Q, J_p_aug)
        r_rot = torch.einsum("pmi,pm->pi", Q, r_aug)
        # The nullspace rows, gauge-masked, with b as one more column.
        Ab = torch.cat([Jp_rot[:, 3:, :].reshape(-1, 6 * C) * free,
                        r_rot[:, 3:].reshape(-1, 1)], dim=1)
        R_loc = torch.linalg.qr(Ab, mode="r")[1]  # [6C+1, 6C+1]
        parts = [torch.empty_like(R_loc) for _ in range(mesh.n_data)]
        dist.all_gather(parts, R_loc.contiguous(), group=mesh.data_group)
        damp = torch.cat([sqrt_l * torch.eye(6 * C, dtype=dtype, device=dev),
                          torch.zeros(6 * C, 1, dtype=dtype, device=dev)], dim=1)
        R_fin = torch.linalg.qr(torch.cat([*parts, damp], dim=0), mode="r")[1]
        Rp, c = R_fin[:6 * C, :6 * C], R_fin[:6 * C, 6 * C]
        delta_c = -torch.linalg.solve_triangular(Rp, c[:, None], upper=True)[:, 0]
        delta_c = (delta_c * free).reshape(C, 6)
        rhs = -(r_rot[:, :3] + torch.einsum("pik,k->pi", Jp_rot[:, :3, :], delta_c.reshape(-1)))
        delta_p = torch.linalg.solve_triangular(R_land, rhs[..., None], upper=True)[..., 0]
        (cost,) = sum_over(mesh.data_group, cost)
        return se3_exp(delta_c) @ poses, points_l + delta_p, cost

    return step


def pad_pose_graph_edges(edges, measurements, weights, multiple: int):
    """The edge axis padded to a multiple with zero-weight (0, 0) identity
    self-edges (residual 0 and weight 0: exact no-ops); weights [E] or [E,
    6] come back [E', 6]."""
    w6 = weights[:, None].expand(-1, 6) if weights.ndim == 1 else weights
    pad = -edges.shape[0] % multiple
    if pad == 0:
        return edges, measurements, w6
    eye = torch.eye(4, dtype=measurements.dtype, device=measurements.device)
    return (torch.cat([edges, edges.new_zeros(pad, 2)]),
            torch.cat([measurements, eye.expand(pad, 4, 4)]),
            torch.cat([w6, w6.new_zeros(pad, 6)]))


def shard_edges(mesh: Mesh, edges, measurements, weights):
    """This rank's edges (the count must divide by the data group's size:
    `pad_pose_graph_edges` first)."""
    return shard(mesh, edges), shard(mesh, measurements), shard(mesh, weights)


def make_distributed_pose_graph_step(mesh: Mesh, damping: float = 1e-6, fix_first: bool = True,
                                     huber_delta: float | None = None):
    """step(poses [N, 4, 4], edges_l, meas_l, w_l [E/n, 6], dof_mask [6]) ->
    (poses, cost): one Gauss-Newton step with the edges sharded. `cost` is
    the sum of the weighted squared residuals (the one-device step reports
    their mean)."""

    @no_tf32()
    def step(poses, edges_l, meas_l, w_l, dof_mask):
        N = poses.shape[0]
        dtype, dev = poses.dtype, poses.device
        w = w_l
        if huber_delta is not None:
            rnorm = torch.linalg.vector_norm(edge_residuals(poses, edges_l, meas_l), dim=-1)
            w = w * torch.clamp(huber_delta / (rnorm + 1e-12), max=1.0)[:, None]
        sqrt_w = torch.sqrt(w)

        def residual_of_delta(delta):
            p = _apply_delta(poses, delta.reshape(N, 6))
            return (edge_residuals(p, edges_l, meas_l) * sqrt_w).reshape(-1)

        delta0 = torch.zeros(N * 6, dtype=dtype, device=dev)
        r0 = residual_of_delta(delta0)
        J = jacrev(residual_of_delta)(delta0)  # [6 E/n, 6N]
        H, g, cost = sum_over(mesh.data_group, J.T @ J, J.T @ r0, torch.sum(r0 * r0))
        mask = torch.as_tensor(dof_mask, device=dev).bool().repeat(N)
        if fix_first:
            mask &= torch.arange(N * 6, device=dev) >= 6
        m = mask.to(dtype)
        H = H * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        H = H + damping * torch.eye(N * 6, dtype=dtype, device=dev)
        delta = -torch.linalg.solve(H, (g * m)[:, None])[:, 0]
        return _apply_delta(poses, delta.reshape(N, 6)), cost

    return step


def optimize_pose_graph_two_stage_distributed(
        mesh: Mesh, graph: PoseGraph, rot_iters: int = 10, trans_iters: int = 10,
        damping: float = 1e-6, huber_delta: float | None = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-stage solve (rotations with the ω weights, then translations
    with the rotations frozen) with edge-sharded steps; `graph` is the
    global graph on every rank. Returns (poses, the cost of every step)."""
    edges, meas, w6 = shard_edges(mesh, *pad_pose_graph_edges(
        graph.edges, graph.measurements, graph.weights, mesh.size(DATA_AXIS)))
    step = make_distributed_pose_graph_step(mesh, damping=damping, huber_delta=huber_delta)
    rot_only = torch.tensor([0.0, 0, 0, 1, 1, 1], dtype=w6.dtype, device=w6.device)
    poses, costs = graph.poses, []
    for _ in range(rot_iters):
        poses, c = step(poses, edges, meas, w6 * rot_only, rot_only)
        costs.append(c)
    for _ in range(trans_iters):
        poses, c = step(poses, edges, meas, w6, 1.0 - rot_only)
        costs.append(c)
    return poses, torch.stack(costs)
