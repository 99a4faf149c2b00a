"""Arm FK + sphere centres + geometric Jacobian: kernel K2, plain twin, dispatch.

`arm_fk_spheres_cuda` launches the hand-written CUDA kernel
(csrc/fk_arm.cu), which replaces the TPU kernel
gpmp2_tpu/ops/fk_arm.py:_fk_kernel. `fk_spheres_torch` is the plain
PyTorch version of the same function, a port of
gpmp2_tpu/ops/fk_arm.py:_fk_spheres_jnp. `arm_fk_spheres_batched` takes
the plain version for CPU tensors and the kernel for CUDA tensors.

Unlike the JAX package, where this kernel is opt-in, the port's obstacle
linearize always runs through it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..kinematics.fk import ArmFK
from ..utils import trace

__all__ = ["structure_arrays", "fk_spheres_torch", "arm_fk_spheres_cuda",
           "arm_fk_spheres_batched", "launch_plan", "MAX_DOF"]

MAX_DOF = 16  # largest dof the kernel is built for (csrc/fk_arm.cu kMaxDof)
_CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue


def structure_arrays(model, dtype, device):
    """Kernel operands from an ArmFK RobotModel: consts (5, d) =
    [a, dz, theta_bias, cos alpha, sin alpha], base (3, 4) = [R | t],
    scent (S, 3) local sphere centres, link_ids (S,) int32."""
    fk = model.fk
    if not isinstance(fk, ArmFK):
        raise NotImplementedError(f"FK family {type(fk).__name__} is a later slice")
    f = lambda t: t.to(dtype=dtype, device=device)  # noqa: E731
    alpha = f(fk.alpha)
    consts = torch.stack([f(fk.a), f(fk.d), f(fk.theta_bias),
                          torch.cos(alpha), torch.sin(alpha)])
    base = torch.cat([f(fk.base_rot), f(fk.base_trans)[:, None]], dim=1)
    scent = f(model.sphere_centers).contiguous()
    link_ids = model.sphere_link_ids.to(dtype=torch.int32, device=device)
    return consts.contiguous(), base.contiguous(), scent, link_ids


def fk_spheres_torch(consts, base, scent, link_ids, qflat):
    """Plain PyTorch version: qflat (N, d) -> centres (N, S, 3), J (N, S, 3, d)."""
    a, dz, bias, ca, sa = consts
    N, d = qflat.shape
    onehot = (link_ids[:, None] == torch.arange(d, device=qflat.device)).to(qflat.dtype)
    jmask = (torch.arange(d, device=qflat.device)[None, :] <= link_ids[:, None]).to(qflat.dtype)
    R = base[:, :3].expand(N, 3, 3)
    t = base[:, 3].expand(N, 3)
    link_R, link_t, z_ax, o_pt = [], [], [], []
    for j in range(d):
        z_ax.append(R[..., :, 2])
        o_pt.append(t)
        ct = torch.cos(qflat[:, j] + bias[j])
        st = torch.sin(qflat[:, j] + bias[j])
        zero = torch.zeros_like(ct)
        A = torch.stack([
            torch.stack([ct, -st * ca[j], st * sa[j]], -1),
            torch.stack([st, ct * ca[j], -ct * sa[j]], -1),
            torch.stack([zero, zero + sa[j], zero + ca[j]], -1),
        ], -2)  # (N, 3, 3)
        tr = torch.stack([a[j] * ct, a[j] * st, zero + dz[j]], -1)
        t = t + (R @ tr[..., None])[..., 0]
        R = R @ A
        link_R.append(R)
        link_t.append(t)
    Rl = torch.stack(link_R, 1)  # (N, d, 3, 3)
    tl = torch.stack(link_t, 1)  # (N, d, 3)
    centers = (torch.einsum("sl,nlij,sj->nsi", onehot, Rl, scent)
               + torch.einsum("sl,nli->nsi", onehot, tl))  # (N, S, 3)
    z = torch.stack(z_ax, 1)  # (N, d, 3)
    o = torch.stack(o_pt, 1)
    rel = centers[:, :, None, :] - o[:, None, :, :]  # (N, S, d, 3)
    cr = torch.linalg.cross(z[:, None].expand_as(rel), rel)
    J = (jmask[None, :, :, None] * cr).transpose(-1, -2)  # (N, S, 3, d)
    return centers, J


def launch_plan(d: int, S: int, dtype) -> tuple[int, int, int]:
    """(configurations per block, threads, shared-memory bytes) of one K2
    block, from the kernel's own plan (csrc/fk_arm.cu fk_plan), for the
    tests; the launcher computes the same plan itself. Needs the built
    library; raises ValueError where no tile of configurations fits in
    shared memory."""
    out = (ctypes.c_int * 3)()
    if _build.kernels_lib().gpmp2_fk_arm_plan(d, S, int(dtype == torch.float64), out):
        raise ValueError(f"no K2 tile of {S} spheres at dof {d} ({dtype}) "
                         "fits in shared memory")
    return out[0], out[1], out[2]


def arm_fk_spheres_cuda(consts, base, scent, link_ids, qflat):
    """Launch kernel K2 (csrc/fk_arm.cu) on CUDA tensors; same semantics as
    `fk_spheres_torch`. Raises on what the kernel does not take."""
    if qflat.dim() != 2:
        raise ValueError(f"qflat must be (N, d), got {tuple(qflat.shape)}")
    N, d = qflat.shape
    S = scent.shape[0]
    if not 1 <= d <= MAX_DOF:
        raise ValueError(f"dof {d} must be in [1, {MAX_DOF}]")
    dtype, device = qflat.dtype, qflat.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"qflat must be float32 or float64, got {dtype}")
    shapes = {"qflat": (qflat, (N, d), dtype), "consts": (consts, (5, d), dtype),
              "base": (base, (3, 4), dtype), "scent": (scent, (S, 3), dtype),
              "link_ids": (link_ids, (S,), torch.int32)}
    for name, (t, shape, want) in shapes.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} must be a CUDA tensor on {device}")
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # fresh allocations: 16-byte aligned, as the kernel's vector stores need
    centers = torch.empty((N, S, 3), dtype=dtype, device=device)
    J = torch.empty((N, S, 3, d), dtype=dtype, device=device)
    if N == 0:
        return centers, J
    lib = _build.kernels_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gpmp2_fk_arm(
            qflat.data_ptr(), consts.data_ptr(), base.data_ptr(),
            scent.data_ptr(), link_ids.data_ptr(), centers.data_ptr(),
            J.data_ptr(), N, d, S, int(dtype == torch.float64),
            ctypes.c_void_p(stream))
    if rc == _CUDA_ERROR_INVALID_VALUE:  # d is checked above: fk_plan found no tile
        raise ValueError(f"no K2 tile of {S} spheres at dof {d} ({dtype}) "
                         "fits in shared memory")
    _build.check(rc, "fk_arm launch")
    trace.count("launches.k2")
    return centers, J


def arm_fk_spheres_batched(model, qs):
    """Sphere centres and geometric Jacobians for an ArmFK model:
    qs (..., d) -> centres (..., S, 3), J (..., S, 3, d). Kernel K2 for CUDA
    tensors, the plain version for CPU tensors."""
    lead, d = qs.shape[:-1], qs.shape[-1]
    flat = qs.reshape(-1, d)
    ops = structure_arrays(model, qs.dtype, qs.device)
    if qs.is_cuda:
        centers, J = arm_fk_spheres_cuda(*ops, flat.contiguous())
    elif qs.device.type == "cpu":
        centers, J = fk_spheres_torch(*ops, flat)
    else:
        raise ValueError(f"no FK for device {qs.device}")
    S = centers.shape[1]
    return centers.reshape(lead + (S, 3)), J.reshape(lead + (S, 3, d))
