"""The vector-space linearize's assembly: the assembly kernel, its plain
version, and the route.

`assemble_vec_cuda` launches the hand-written CUDA kernel
(csrc/assemble_vec.cu), which writes the whole (H_diag, H_off, b, err) of
`planner/problem.py::traj_linearize` on a vector space in one launch, from
K2's sphere Jacobians and K3's lookup: the hinge and -g . J, the support
states' obstacle Grams, each interval's factored Gram pushed through the
constant interpolation coefficients, the boundary priors and the GP prior.
It replaces no TPU kernel (the JAX package leaves this to XLA); on the
card it takes the place of ~250 PyTorch operations a linearize.
`assemble_vec_torch` is the plain PyTorch version of the same function of
the same operands. `traj_linearize` takes the kernel where `route` says
so; its own torch code stays the CPU path and the route of the Lie
spaces.

Operands (both versions), for B problems of n support states of d dims,
m = 2d, T interpolated states an interval, C = n + (n-1) T collision
states (support states first) and S spheres:
- pose, vel (B, n, d);
- Jc (B, C, S, 3, d): the spheres' position Jacobians (K2);
- dist, gx, gy[, gz], ok (B, C, S): the lookup (K3); gz None on a planar
  field;
- eps_total (S,) = sphere radii + eps, obs_w () the obstacle precision;
- coeff (T, d, 2m) = [Lambda | Psi][:d] of each tau;
- J1, J2 (m, m) the GP prior's constant Jacobians, W (m, m) its
  precision;
- start_pose, start_vel (B, d), pose_w, vel_w (d,): the start prior;
- end_pose, end_vel, goal_pose_w, goal_vel_w (B, d): the goal prior,
  left out where `goal_prior` is False (an end-effector goal replaces it).
Returns H_diag (B, n, m, m), H_off (B, n-1, m, m), b (B, n, m), err (B,).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import trace

__all__ = ["route", "launch_plan", "assemble_vec_torch", "assemble_vec_cuda",
           "MAX_DOF", "MAX_SPHERES", "MAX_INTER"]

# the kernel's built range (csrc/assemble_vec.cu kMaxDof, kMaxSpheres, kMaxInter)
MAX_DOF = 8
MAX_SPHERES = 64
MAX_INTER = 16


def route(vector: bool, cuda: bool, dtype, d: int, S: int, T: int) -> bool:
    """Whether a linearize takes the assembly kernel: a vector space, CUDA
    tensors of float32 or float64, and d, S, T within the kernel's built
    range."""
    return (vector and cuda and dtype in (torch.float32, torch.float64)
            and 1 <= d <= MAX_DOF and 1 <= S <= MAX_SPHERES and 0 <= T <= MAX_INTER)


def launch_plan(d: int, S: int, T: int, dtype) -> tuple[int, int, int]:
    """(states a chunk, threads, shared-memory bytes) of one block, from
    the kernel's own plan (csrc/assemble_vec.cu assemble_plan). Needs the
    built library; raises ValueError outside the built range."""
    out = (ctypes.c_int * 3)()
    if _build.kernels_lib().gpmp2_assemble_vec_plan(d, S, T, int(dtype == torch.float64),
                                                    out):
        raise ValueError(f"d={d}, S={S}, T={T} lie outside the assembly kernel's range")
    return out[0], out[1], out[2]


def assemble_vec_torch(pose, vel, Jc, dist, gx, gy, gz, ok, eps_total, obs_w, coeff, J1, J2,
                       W, start_pose, start_vel, pose_w, vel_w, end_pose, end_vel,
                       goal_pose_w, goal_vel_w, goal_prior=True):
    """Plain PyTorch version of the assembly kernel (module docstring)."""
    B, n, d = pose.shape
    m = 2 * d
    T = coeff.shape[0]
    zero = torch.zeros((), dtype=pose.dtype, device=pose.device)
    active = ok & (dist <= eps_total)
    r = torch.where(active, eps_total - dist, zero)  # (B, C, S)
    dot = gx[..., None] * Jc[..., 0, :] + gy[..., None] * Jc[..., 1, :]
    if gz is not None:
        dot = dot + gz[..., None] * Jc[..., 2, :]
    J = torch.where(active[..., None], -dot, zero)  # (B, C, S, d)
    G, g = J.mT @ J, (J.mT @ r[..., None])[..., 0]
    H_diag = torch.zeros((B, n, m, m), dtype=pose.dtype, device=pose.device)
    H_off = torch.zeros((B, n - 1, m, m), dtype=pose.dtype, device=pose.device)
    b = torch.zeros((B, n, m), dtype=pose.dtype, device=pose.device)
    H_diag[:, :, :d, :d] += obs_w * G[:, :n]
    b[:, :, :d] -= obs_w * g[:, :n]
    if T:
        Gt = G[:, n:].reshape(B, n - 1, T, d, d)
        gt = g[:, n:].reshape(B, n - 1, T, d)
        Hfull = obs_w * torch.einsum("tdE,bitdf,tfF->biEF", coeff, Gt, coeff)
        gfull = obs_w * torch.einsum("tdE,bitd->biE", coeff, gt)
        H_diag[:, :-1] += Hfull[..., :m, :m]
        H_diag[:, 1:] += Hfull[..., m:, m:]
        H_off += Hfull[..., :m, m:]
        b[:, :-1] -= gfull[..., :m]
        b[:, 1:] -= gfull[..., m:]
    z = torch.cat([pose, vel], dim=-1)  # (B, n, m)
    r_gp = z[:, :-1] @ J1.mT + z[:, 1:] @ J2.mT
    Wr = r_gp @ W.mT
    H_diag[:, :-1] += J1.mT @ W @ J1
    H_diag[:, 1:] += J2.mT @ W @ J2
    H_off += J1.mT @ W @ J2
    b[:, :-1] -= Wr @ J1
    b[:, 1:] -= Wr @ J2
    err = 0.5 * obs_w * (r * r).reshape(B, -1).sum(-1) + 0.5 * (r_gp * Wr).reshape(B, -1).sum(-1)
    priors = [(0, torch.cat([start_pose, start_vel], -1), torch.cat([pose_w, vel_w]))]
    if goal_prior:
        priors.append((n - 1, torch.cat([end_pose, end_vel], -1),
                       torch.cat([goal_pose_w, goal_vel_w], -1)))
    for idx, mean, w in priors:
        rp = z[:, idx] - mean
        H_diag[:, idx] += torch.diag_embed(w.expand(B, m))
        b[:, idx] -= w * rp
        err = err + 0.5 * (w * rp * rp).sum(-1)
    return H_diag, H_off, b, err


def assemble_vec_cuda(pose, vel, Jc, dist, gx, gy, gz, ok, eps_total, obs_w, coeff, J1, J2,
                      W, start_pose, start_vel, pose_w, vel_w, end_pose, end_vel,
                      goal_pose_w, goal_vel_w, goal_prior=True):
    """Launch the assembly kernel (csrc/assemble_vec.cu) on CUDA tensors;
    same semantics as `assemble_vec_torch`. Raises on what the kernel does
    not take."""
    B, n, d = pose.shape
    m = 2 * d
    S = Jc.shape[2]
    T = coeff.shape[0]
    C = n + (n - 1) * T
    dtype, device = pose.dtype, pose.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pose must be float32 or float64, got {dtype}")
    if not route(True, pose.is_cuda, dtype, d, S, T):
        raise ValueError(f"d={d}, S={S}, T={T} on {device} lie outside the assembly "
                         "kernel's range")
    operands = {"pose": (pose, (B, n, d)), "vel": (vel, (B, n, d)),
                "Jc": (Jc, (B, C, S, 3, d)), "dist": (dist, (B, C, S)),
                "gx": (gx, (B, C, S)), "gy": (gy, (B, C, S)), "gz": (gz, (B, C, S)),
                "ok": (ok, (B, C, S)), "eps_total": (eps_total, (S,)), "obs_w": (obs_w, ()),
                "coeff": (coeff, (T, d, 2 * m)), "J1": (J1, (m, m)), "J2": (J2, (m, m)),
                "W": (W, (m, m)), "start_pose": (start_pose, (B, d)),
                "start_vel": (start_vel, (B, d)), "pose_w": (pose_w, (d,)),
                "vel_w": (vel_w, (d,)), "end_pose": (end_pose, (B, d)),
                "end_vel": (end_vel, (B, d)), "goal_pose_w": (goal_pose_w, (B, d)),
                "goal_vel_w": (goal_vel_w, (B, d))}
    ptrs = []
    for name, (t, shape) in operands.items():
        if t is None and name == "gz":
            ptrs.append(None)
            continue
        want = torch.bool if name == "ok" else dtype
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}")
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        ptrs.append(t.data_ptr() if t.numel() else None)
    H_diag = torch.empty((B, n, m, m), dtype=dtype, device=device)
    H_off = torch.empty((B, n - 1, m, m), dtype=dtype, device=device)
    b = torch.empty((B, n, m), dtype=dtype, device=device)
    err = torch.empty((B,), dtype=dtype, device=device)
    if B == 0:
        return H_diag, H_off, b, err
    ptrs += [t.data_ptr() for t in (H_diag, H_off, b, err)]
    lib = _build.kernels_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gpmp2_assemble_vec((ctypes.c_void_p * len(ptrs))(*ptrs), B, n, d, S, T,
                                    int(goal_prior), int(dtype == torch.float64),
                                    ctypes.c_void_p(stream))
    _build.check(rc, "assemble_vec launch")
    trace.count("launches.assemble")
    return H_diag, H_off, b, err
