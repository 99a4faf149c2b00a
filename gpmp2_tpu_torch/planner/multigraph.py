"""Multi-chain planner graphs: joint optimization over a DAG of candidate
trajectories, then shortest-path extraction.

Port of gpmp2_tpu/planner/multigraph.py (the reference Python toolbox's
examples/multi_graph/graph_utils.py):

- `sample_initializations` (get_initializations, graph_utils.py:91-160):
  candidate trajectories drawn from the GP posterior of the prior-only
  chain, which is exactly Gaussian: mean + L^-T z with L the Cholesky
  factor of the dense joint precision. `chain_posterior` gives the mean
  and precision, `posterior_draw` the draw for a given z;
- `build_planner_graph` (get_planner_graph, graph_utils.py:287-341): node
  0 = start, node 1 = goal, nodes 2.. = the chains' interiors; chain edges
  plus random inter-chain edges with probability `connect_prob`;
- `MultiGraphProblem`, `multigraph_error`, `optimize_multigraph`
  (get_gtsam_graph, graph_utils.py:344-421): unary obstacle factors on
  every node but node 0, a GP prior and GP-interpolated obstacle factors
  per edge, start and goal priors. The graph is not a chain, so the
  normal equations are dense: the whitened Jacobian J is assembled block
  by block (the obstacle rows analytically through the planner's sphere
  pass and lookup, K2 and K3 on CUDA tensors, never under torch.func; the
  prior and GP rows in closed form on a vector space, by torch.func on
  the Lie spaces), then H = J^T J and a Cholesky solve in torch.linalg,
  as the JAX package solves them with jnp.linalg outside any kernel;
- `edge_costs` / `shortest_path` (Planner.get_edge_cost /
  get_shortest_path, graph_utils.py:431-480): every edge's GP and
  interpolated-obstacle error and every node's obstacle error in one
  batched pass, then Dijkstra on the host. Nodes are finalized when
  popped, not when pushed as in the reference, whose variant can return
  a longer path.

Costs follow gtsam::NonlinearFactorGraph::error: 0.5 * the sum of weighted
squared residuals, as planner/problem.py. Graphs are unbatched: pose
(M, d) and vel (M, d) over M nodes.
"""

from __future__ import annotations

import dataclasses
import heapq
import warnings
from typing import Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..device import host_array, resolve_device
from ..geometry.statespace import StateSpace
from ..gp.gputils import calc_Q_inv
from ..gp.interpolator import interp_coeffs, interpolate_pose
from ..gp.prior import gp_prior_error, gp_prior_jacobians_linear
from ..kinematics.robot import RobotModel, sphere_centers_world
from ..obstacle.sdf import PlanarSDF
from .problem import (_interval_interp_jacobians, _obs_err, _obs_res_and_jac,
                      _prior_pose_jacobian, _spheres_and_jac, _split_tangent)

__all__ = ["MultiGraphProblem", "chain_posterior", "posterior_draw", "sample_initializations",
           "build_planner_graph", "make_multigraph_problem", "multigraph_error",
           "optimize_multigraph", "edge_costs", "shortest_path"]


@dataclasses.dataclass(frozen=True)
class MultiGraphProblem:
    """A factor graph over M free nodes with an arbitrary edge set.

    Values are node tensors (pose (M, d), vel (M, d)); `edges` (E, 2) holds
    (parent, child) node pairs, each carrying a GP prior and the
    interpolated obstacle factors. Unary obstacle factors sit on every node
    but node 0 (get_gtsam_graph adds them for i > 0)."""

    robot: RobotModel
    sdf: object
    dt: torch.Tensor  # () per-edge GP time step
    Qc: torch.Tensor  # (d, d)
    obs_w: torch.Tensor  # () 1 / cost_sigma^2
    eps: torch.Tensor  # ()
    taus: torch.Tensor  # (inter,) interpolation offsets within an edge
    edges: torch.Tensor  # (E, 2) int64
    prior_pose: torch.Tensor  # (2, d) start and goal anchors (nodes 0, 1)
    prior_vel: torch.Tensor  # (2, d)
    pose_prior_w: torch.Tensor  # (d,)
    vel_prior_w: torch.Tensor  # (d,)
    planar: bool = True

    @property
    def space(self) -> StateSpace:
        return self.robot.space


# ---- initialization sampling (graph_utils.py get_initializations) ----------

def chain_posterior(space: StateSpace, start, end, n_steps: int, total_time: float, Qc,
                    prior_sigma: float = 1e-4, device=None):
    """The GP posterior of the prior-only chain (endpoint priors + GP
    factors; graph_utils.py:91-160) over the flat states
    [x_0, v_0, ..., x_N, v_N]: its mean (n 2d,), the straight line with the
    average velocity, and its dense joint precision H (n 2d, n 2d). Vector
    spaces only (the reference samples gtsam VectorValues). Tensors on
    `device` (default: start's device when it is a tensor, else CUDA) in
    start's dtype."""
    if space.kind != "vector":
        raise ValueError("sampling requires a vector space")
    if device is None:
        device = start.device if torch.is_tensor(start) else resolve_device()
    start = torch.as_tensor(start, device=device)
    end = torch.as_tensor(end, dtype=start.dtype, device=device)
    dtype, d, n = start.dtype, space.dim, n_steps + 1
    dt = total_time / n_steps
    ts = torch.arange(n, dtype=dtype, device=device)[:, None] / n_steps
    mean_pose = start[None] * (1 - ts) + end[None] * ts
    avg_vel = (end - start) / total_time
    mean = torch.cat([mean_pose, avg_vel.expand(n, d)], dim=1).reshape(-1)
    # each GP factor's r = x_{i+1} - Phi x_i with weight Q^-1 (GPutils.h:41-58)
    Qinv = calc_Q_inv(torch.as_tensor(Qc, dtype=dtype, device=device), dt)
    eye = torch.eye(d, dtype=dtype, device=device)
    Phi = torch.cat([torch.cat([eye, dt * eye], 1),
                     torch.cat([torch.zeros_like(eye), eye], 1)], 0)
    A = torch.cat([-Phi, torch.eye(2 * d, dtype=dtype, device=device)], dim=1)
    blk = A.T @ Qinv @ A  # (4d, 4d)
    H = torch.zeros((n * 2 * d, n * 2 * d), dtype=dtype, device=device)
    for i in range(n_steps):
        s = i * 2 * d
        H[s:s + 4 * d, s:s + 4 * d] += blk
    wp = 1.0 / prior_sigma**2
    ends = torch.cat([torch.arange(2 * d, device=device),
                      (n - 1) * 2 * d + torch.arange(2 * d, device=device)])
    H[ends, ends] += wp
    return mean, H


def posterior_draw(mean, H, z, start, end, d: int):
    """Samples mean + L^-T z (covariance H^-1 = L^-T L^-1) for z
    (n_chains, n 2d): their poses (n_chains, n, d), with the first and last
    rows set to start and end, as the reference fixes them."""
    L = torch.linalg.cholesky(H)
    dev = torch.linalg.solve_triangular(L.T, z.T, upper=True).T
    samples = (mean[None] + dev).reshape(z.shape[0], -1, 2 * d)[..., :d].clone()
    samples[:, 0] = torch.as_tensor(start, dtype=samples.dtype, device=samples.device)
    samples[:, -1] = torch.as_tensor(end, dtype=samples.dtype, device=samples.device)
    return samples


def sample_initializations(space: StateSpace, start, end, n_steps: int, total_time: float,
                           Qc, n_chains: int, generator: Optional[torch.Generator] = None,
                           prior_sigma: float = 1e-4, device=None):
    """Draw `n_chains` candidate trajectories (n_chains, n_steps + 1, d)
    from the GP posterior of the prior-only chain (`chain_posterior`),
    with z ~ N(0, I) from `generator` (the global generator when None),
    drawn on the generator's device."""
    mean, H = chain_posterior(space, start, end, n_steps, total_time, Qc, prior_sigma, device)
    gen_device = generator.device if generator is not None else mean.device
    z = torch.randn((n_chains, mean.shape[0]), generator=generator, dtype=mean.dtype,
                    device=gen_device).to(mean.device)
    return posterior_draw(mean, H, z, start, end, space.dim)


# ---- planner-graph construction (host side; the topology is static) --------

def build_planner_graph(chains, avg_vel, connect_prob: float = 0.0, seed: Optional[int] = None):
    """Nodes and edges of the multi-chain planner graph (get_planner_graph,
    graph_utils.py:287-341).

    chains: (n_chains, T+1, d) candidate trajectories sharing endpoints.
    Node 0 = the shared start, node 1 = the shared goal, then the chains'
    interiors in chain-major order. Chain edges connect consecutive states;
    random inter-chain edges (i, j) -> (k, j+1) are added with probability
    `connect_prob` for k != i, drawn from numpy's default_rng(seed).

    Returns numpy (node_pose (M, d), node_vel (M, d), edges (E, 2) int32)."""
    chains = host_array(chains)
    n_chains, n, d = chains.shape
    T = n - 1
    avg_vel = np.broadcast_to(host_array(avg_vel), (d,))

    poses = [chains[0, 0], chains[0, -1]]
    index = {}
    for c in range(n_chains):
        for j in range(1, T):
            index[(c, j)] = len(poses)
            poses.append(chains[c, j])
    node_pose = np.stack(poses)
    node_vel = np.tile(avg_vel, (len(poses), 1))

    edges = []
    for c in range(n_chains):
        for j in range(T):
            a = 0 if j == 0 else index[(c, j)]
            b = 1 if j == T - 1 else index[(c, j + 1)]
            edges.append((a, b))
    rng = np.random.default_rng(seed)
    for c in range(n_chains):
        for j in range(1, T - 1):
            for k in range(n_chains):
                if k == c:
                    continue
                if rng.random() < connect_prob:
                    edges.append((index[(c, j)], index[(k, j + 1)]))
    return node_pose, node_vel, np.asarray(edges, np.int32)


def make_multigraph_problem(robot: RobotModel, sdf, edges, start_pose, start_vel, goal_pose,
                            goal_vel, *, dt, Qc, cost_sigma: float, epsilon: float,
                            obs_check_inter: int = 0, fix_sigma: float = 1e-4,
                            dtype=torch.float32, device=None) -> MultiGraphProblem:
    """The factor-graph program over a planner graph (get_gtsam_graph,
    graph_utils.py:344-421), with the robot and field cast to `dtype` on
    `device` (default: start_pose's device when it is a tensor, else
    CUDA)."""
    if device is None:
        device = start_pose.device if torch.is_tensor(start_pose) else resolve_device()
    f = lambda x: torch.as_tensor(host_array(x), dtype=dtype, device=device)  # noqa: E731
    d = robot.space.dim
    inter = int(obs_check_inter)
    return MultiGraphProblem(
        robot=robot.to(dtype=dtype, device=device), sdf=sdf.to(dtype=dtype, device=device),
        dt=f(dt), Qc=f(Qc), obs_w=f(1.0 / cost_sigma**2), eps=f(epsilon),
        taus=torch.arange(1, inter + 1, dtype=dtype, device=device) * (dt / (inter + 1)),
        edges=torch.as_tensor(host_array(edges).astype(np.int64), device=device),
        prior_pose=torch.stack([f(start_pose), f(goal_pose)]),
        prior_vel=torch.stack([f(start_vel), f(goal_vel)]),
        pose_prior_w=torch.full((d,), 1.0 / fix_sigma**2, dtype=dtype, device=device),
        vel_prior_w=torch.full((d,), 1.0 / fix_sigma**2, dtype=dtype, device=device),
        planar=isinstance(sdf, PlanarSDF),
    )


# ---- factor evaluation --------------------------------------------------------

def _quad(W, r):
    """0.5 * sum W r^2 over every axis."""
    return 0.5 * (W * r * r).sum()


def _edge_ends(prob: MultiGraphProblem, pose, vel):
    a, b = prob.edges[:, 0], prob.edges[:, 1]
    return pose[a], vel[a], pose[b], vel[b]


def _edge_confs(prob: MultiGraphProblem, ends):
    """The interpolated configurations (E, inter, d) of every edge."""
    return interpolate_pose(prob.space, interp_coeffs(prob.Qc, prob.dt, prob.taus),
                            *(e[:, None] for e in ends))


def _obs_res(prob: MultiGraphProblem, q):
    """Obstacle hinge residuals (..., S) of configurations (..., d)."""
    return _obs_err(prob.robot, prob.sdf, prob.eps, sphere_centers_world(prob.robot, q))


def _edge_residuals(prob: MultiGraphProblem, pose, vel):
    """Per-edge GP residuals (E, 2d) and interpolated-obstacle residuals
    (E, inter, S)."""
    ends = _edge_ends(prob, pose, vel)
    gp_r = gp_prior_error(prob.space, *ends, prob.dt)
    return gp_r, _obs_res(prob, _edge_confs(prob, ends))


def multigraph_error(prob: MultiGraphProblem, pose, vel):
    """Total graph error (gtsam::NonlinearFactorGraph::error semantics), a
    0-dim tensor."""
    space = prob.space
    err = torch.zeros((), dtype=pose.dtype, device=pose.device)
    for k in range(2):
        err = err + _quad(prob.pose_prior_w, space.local(prob.prior_pose[k], pose[k]))
        err = err + _quad(prob.vel_prior_w, vel[k] - prob.prior_vel[k])
    err = err + _quad(prob.obs_w, _obs_res(prob, pose[1:]))  # reference: i > 0
    gp_r, obs_r = _edge_residuals(prob, pose, vel)
    Qinv = calc_Q_inv(prob.Qc, prob.dt)
    err = err + 0.5 * torch.einsum("ei,ij,ej->", gp_r, Qinv, gp_r)
    return err + _quad(prob.obs_w, obs_r)


def edge_costs(prob: MultiGraphProblem, pose, vel):
    """(edge_cost (E,), node_obs_cost (M,)): every edge's GP and
    interpolated-obstacle factor errors and every node's unary obstacle
    error, which Dijkstra reads (Planner.get_edge_cost,
    graph_utils.py:437-445); one batched pass."""
    gp_r, obs_r = _edge_residuals(prob, pose, vel)
    Qinv = calc_Q_inv(prob.Qc, prob.dt)
    e_gp = 0.5 * torch.einsum("ei,ij,ej->e", gp_r, Qinv, gp_r)
    e_obs = 0.5 * prob.obs_w * (obs_r**2).sum(dim=(1, 2))
    node_cost = 0.5 * prob.obs_w * (_obs_res(prob, pose)**2).sum(dim=1)
    return e_gp + e_obs, node_cost


# ---- dense LM (arbitrary topology -> dense normal equations) ---------------

def _whitened_system(prob: MultiGraphProblem, pose, vel):
    """The whitened residual r (R,) and its dense Jacobian J (R, M 2d) wrt
    the node tangents [dp_j, dv_j], with 0.5 |r|^2 = the graph error. Rows
    in the JAX package's order (gpmp2_tpu/planner/multigraph.py:324-337):
    the start and goal priors, the node obstacle factors, the GP priors,
    the interpolated obstacle factors."""
    space = prob.space
    M, d = pose.shape
    m = 2 * d
    E, T, S = prob.edges.shape[0], prob.taus.shape[0], prob.robot.num_spheres
    dev = pose.device
    kw = dict(dtype=pose.dtype, device=dev)
    R = 2 * m + (M - 1) * S + E * m + E * T * S
    r = torch.zeros((R,), **kw)
    J = torch.zeros((R, M * m), **kw)
    row = 0

    def rows(res):
        """Write the factors' residuals (K, ...) at the next rows; their
        row indices (K, R_k)."""
        nonlocal row
        idx = row + torch.arange(res.numel(), device=dev).reshape(res.shape[0], -1)
        r[row:row + res.numel()] = res.reshape(-1)
        row += res.numel()
        return idx

    def put(idx, nodes, col, blk):
        """Factor k's Jacobian block (K, R_k, w) at node nodes[k]'s columns
        col..col+w."""
        cc = nodes[:, None] * m + col + torch.arange(blk.shape[-1], device=dev)
        J[idx[:, :, None], cc[:, None, :]] = blk

    sw_pose, sw_vel = prob.pose_prior_w.sqrt(), prob.vel_prior_w.sqrt()
    sw_obs = prob.obs_w.sqrt()
    for k in range(2):
        node = torch.tensor([k], device=dev)
        Jp = (torch.eye(d, **kw) if space.is_vector else
              _prior_pose_jacobian(space, prob.prior_pose[k][None], pose[k][None])[0])
        put(rows((sw_pose * space.local(prob.prior_pose[k], pose[k]))[None]), node, 0,
            (sw_pose[:, None] * Jp)[None])
        put(rows((sw_vel * (vel[k] - prob.prior_vel[k]))[None]), node, d,
            torch.diag(sw_vel)[None])

    # unary obstacle factors on nodes 1..M-1: analytic, K2 / K3 on the card
    r_node, J_node = _obs_res_and_jac(prob.robot, prob.sdf, prob.eps,
                                      *_spheres_and_jac(prob.robot, pose[1:]))
    put(rows(sw_obs * r_node), torch.arange(1, M, device=dev), 0, sw_obs * J_node)

    ends = _edge_ends(prob, pose, vel)
    if space.is_vector:
        gp_r = gp_prior_error(space, *ends, prob.dt)
        H1, H2 = gp_prior_jacobians_linear(d, prob.dt, **kw)
        Jgp = torch.cat([H1, H2], dim=-1).expand(E, m, 2 * m)
    else:
        def f(z, p1, v1, p2, v2):
            res = gp_prior_error(space, *_split_tangent(space, z, p1, v1, p2, v2), prob.dt)
            return res, res

        Jgp, gp_r = vmap(jacfwd(f, has_aux=True), in_dims=(None, 0, 0, 0, 0))(
            torch.zeros(2 * m, **kw), *ends)
    Lgp = torch.linalg.cholesky(calc_Q_inv(prob.Qc, prob.dt)).T  # |Lgp r|^2 = r^T Q^-1 r
    edge_parts = [(gp_r @ Lgp.T, Lgp @ Jgp)]  # (E, 2d), (E, 2d, 2m)

    if T:
        coeffs = interp_coeffs(prob.Qc, prob.dt, prob.taus)
        q = _edge_confs(prob, ends)  # (E, T, d)
        r_int, J_int = _obs_res_and_jac(prob.robot, prob.sdf, prob.eps,
                                        *_spheres_and_jac(prob.robot, q))  # (E, T, S[, d])
        if space.is_vector:  # d conf / d [x1 v1 x2 v2] = [Lambda | Psi][:d]
            dconf = torch.cat([coeffs.lam[:, :d, :], coeffs.psi[:, :d, :]], dim=-1)
        else:
            dconf = _interval_interp_jacobians(space, coeffs, ends, q)  # (E, T, d, 4d)
        edge_parts.append((sw_obs * r_int, sw_obs * (J_int @ dconf).reshape(E, T * S, 2 * m)))
    for res, blk in edge_parts:
        idx = rows(res)
        for k in range(2):
            put(idx, prob.edges[:, k], 0, blk[..., k * m:(k + 1) * m])
    return r, J


def optimize_multigraph(prob: MultiGraphProblem, pose, vel, *, max_iter: int = 100,
                        lambda_init: float = 100.0, lambda_factor: float = 10.0,
                        lambda_max: float = 1e7, rel_thresh: float = 1e-5,
                        abs_thresh: float = 1e-5):
    """LM on the dense normal equations with the semantics of the JAX
    package's fixed-length scan of accept / reject steps
    (gpmp2_tpu/planner/multigraph.py:342-411): once the graph is done
    (converged or gave up) a step changes nothing, so the loop stops there.

    Returns (pose, vel, final_error, iters, converged)."""
    space = prob.space
    M, d = pose.shape[0], space.dim
    nvar = M * 2 * d
    # a dense (nvar x nvar) solve is right for the reference's planner DAGs
    # of tens of nodes; chain-structured problems belong to plan_batch
    if nvar > 2048:
        warnings.warn(
            f"optimize_multigraph: dense normal equations with "
            f"{nvar} variables ({M} nodes x {2 * d}) — O(nvar^2) memory "
            f"and O(nvar^3) solve. Multi-chain planner graphs are meant "
            f"to stay at tens of nodes (graph_utils.py semantics); for "
            f"long chain-structured problems use plan_batch's "
            f"block-tridiagonal solver instead.",
            stacklevel=2)
    kw = dict(dtype=pose.dtype, device=pose.device)
    err = multigraph_error(prob, pose, vel)
    lam = torch.tensor(lambda_init, **kw)
    done = torch.tensor(False, device=pose.device)
    iters = torch.tensor(0, device=pose.device)
    eye = torch.eye(nvar, **kw)
    for _ in range(max_iter):
        r0, J = _whitened_system(prob, pose, vel)
        L, info = torch.linalg.cholesky_ex(J.T @ J + lam * eye)
        delta = torch.cholesky_solve((-J.T @ r0)[:, None], L)[:, 0]
        delta = torch.where(info == 0, delta, torch.full_like(delta, float("nan")))
        dz = delta.reshape(M, 2 * d)
        p_new = space.retract(pose, dz[:, :d])
        v_new = vel + dz[:, d:]
        err_new = multigraph_error(prob, p_new, v_new)
        ok = torch.isfinite(err_new) & (err_new < err)
        pose = torch.where(ok, p_new, pose)
        vel = torch.where(ok, v_new, vel)
        err_next = torch.where(ok, err_new, err)
        lam = torch.where(ok, torch.clamp(lam / lambda_factor, min=1e-10), lam * lambda_factor)
        conv = ok & ((err - err_next <= abs_thresh)
                     | ((err - err_next) / torch.clamp(err, min=1e-30) <= rel_thresh))
        done = conv | (~ok & (lam > lambda_max))
        iters = iters + ok.to(iters.dtype)
        err = err_next
        if bool(done):
            break
    return pose, vel, err, iters, done


# ---- shortest-path extraction (host Dijkstra over the device's costs) ------

def shortest_path(edges, edge_cost, node_cost, start: int = 0, goal: int = 1):
    """Dijkstra over the planner graph. Edge (i -> j) weight = edge_cost +
    node_cost[j] (the unary obstacle error of the entered node; skipped
    when j is the goal, matching get_edge_cost's `second_idx != 1` guard).
    Returns the node-id path start..goal."""
    edges = host_array(edges)
    edge_cost = np.asarray(host_array(edge_cost), np.float64)
    node_cost = np.asarray(host_array(node_cost), np.float64)
    adj = {}
    for (a, b), c in zip(edges, edge_cost):
        w = c + (node_cost[b] if b != goal else 0.0)
        adj.setdefault(int(a), []).append((int(b), float(w)))

    dist = {start: 0.0}
    parent = {start: None}
    finalized = set()
    pq = [(0.0, start)]
    while pq:
        dcur, u = heapq.heappop(pq)
        if u in finalized:
            continue
        finalized.add(u)
        if u == goal:
            break
        for v, w in adj.get(u, ()):
            nd = dcur + w
            if v not in dist or nd < dist[v]:
                dist[v] = nd
                parent[v] = u
                heapq.heappush(pq, (nd, v))
    if goal not in finalized:
        raise ValueError("no path from start to goal in the planner graph")
    path = []
    u = goal
    while u is not None:
        path.append(u)
        u = parent[u]
    return path[::-1]
