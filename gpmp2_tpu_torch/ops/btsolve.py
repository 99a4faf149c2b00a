"""Batched block-tridiagonal SPD solve: kernel K1, its plain twin, dispatch.

`block_tridiag_solve_cuda` launches the hand-written CUDA kernel
(csrc/btsolve.cu), which replaces the TPU kernel
gpmp2_tpu/ops/btsolve.py:_bt_kernel. `block_tridiag_solve_torch` is the
plain PyTorch version of the same function, a port of
gpmp2_tpu/solver/blocktridiag.py:block_tridiag_solve.
`batched_block_tridiag_solve` takes the plain version for CPU tensors and
the kernel for CUDA tensors; there is no other path.

Layout is batch-first: D (B, n, m, m) diagonal blocks, U (B, n-1, m, m)
upper blocks (H[i, i+1] = U[i]), b (B, n, m), per-lane damping lam (B,).
Semantics (both versions): solve (H + lam I) x = b; with `jacobi_scaling`
the system is first scaled symmetrically by
S = diag(rsqrt(max(diag(D) + lam, 1e-30))). A factorization that meets a
non-positive pivot yields non-finite values for that lane, as the JAX
kernel's unrolled Cholesky does; the optimizer rejects such steps.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import trace

__all__ = ["block_tridiag_solve_torch", "block_tridiag_solve_cuda",
           "batched_block_tridiag_solve", "launch_plan", "MAX_BLOCK"]

MAX_BLOCK = 36  # largest block size m = 2 * dof the kernel is built for (PR2: 18 dof)


def block_tridiag_solve_torch(D, U, b, jacobi_scaling: bool = True, lam=None):
    """Plain PyTorch solve (block LDL^T via lower Cholesky, forward sweep
    storing G_i = C_i^{-1} U_i and w_i = C_i^{-1} z_i, back substitution)."""
    B, n, m = b.shape
    if lam is not None:
        D = D + lam[:, None, None, None] * torch.eye(m, dtype=D.dtype, device=D.device)
    if jacobi_scaling:
        diag = torch.diagonal(D, dim1=-2, dim2=-1)  # (B, n, m)
        s = torch.rsqrt(torch.clamp(diag, min=1e-30))
        D = D * s[..., :, None] * s[..., None, :]
        U = U * s[:, :-1, :, None] * s[:, 1:, None, :]
        b = b * s
    nan = torch.full((), float("nan"), dtype=D.dtype, device=D.device)
    PC = torch.zeros((B, m, m), dtype=D.dtype, device=D.device)
    Pz = torch.zeros((B, m, 1), dtype=D.dtype, device=D.device)
    w, G = [], []
    for i in range(n):
        L, info = torch.linalg.cholesky_ex(D[:, i] - PC)
        L = torch.where((info == 0)[:, None, None], L, nan)
        z = b[:, i, :, None] - Pz
        rhs = z if i == n - 1 else torch.cat([U[:, i], z], dim=-1)
        X = torch.cholesky_solve(rhs, L)  # (B, m, m+1) or (B, m, 1)
        w.append(X[..., -1])
        if i < n - 1:
            G.append(X[..., :m])
            carry = U[:, i].mT @ X
            PC, Pz = carry[..., :m], carry[..., m:]
    xs = [w[n - 1]]
    for i in range(n - 2, -1, -1):
        xs.append(w[i] - (G[i] @ xs[-1][..., None])[..., 0])
    x = torch.stack(xs[::-1], dim=1)
    if jacobi_scaling:
        x = x * s
    return x


def launch_plan(m: int, dtype) -> tuple[int, int]:
    """(threads, shared-memory bytes) of one K1 block at block size m, from
    the kernel's own plan (csrc/btsolve.cu bt_plan). Needs the built
    library; raises ValueError for an m the kernel is not built for."""
    out = (ctypes.c_int * 2)()
    if _build.kernels_lib().gpmp2_btsolve_plan(m, int(dtype == torch.float64), out):
        raise ValueError(f"block size m={m} must be even and in [2, {MAX_BLOCK}]")
    return out[0], out[1]


def block_tridiag_solve_cuda(D, U, b, jacobi_scaling: bool = True, lam=None):
    """Launch kernel K1 (csrc/btsolve.cu) on CUDA tensors; same semantics as
    `block_tridiag_solve_torch`. Raises on what the kernel does not take."""
    if b.dim() != 3:
        raise ValueError(f"b must be (B, n, m), got {tuple(b.shape)}")
    B, n, m = b.shape
    if m % 2 or not 2 <= m <= MAX_BLOCK:
        raise ValueError(f"block size m={m} must be even and in [2, {MAX_BLOCK}]")
    if n < 1:
        raise ValueError("need at least one block")
    if lam is None:
        lam = torch.zeros((B,), dtype=b.dtype, device=b.device)
    shapes = {"D": (D, (B, n, m, m)), "U": (U, (B, n - 1, m, m)),
              "b": (b, (B, n, m)), "lam": (lam, (B,))}
    for name, (t, shape) in shapes.items():
        if not t.is_cuda or t.device != b.device:
            raise ValueError(f"{name} must be a CUDA tensor on {b.device}")
        if t.dtype not in (torch.float32, torch.float64) or t.dtype != b.dtype:
            raise ValueError(f"{name} must be float32 or float64 like b, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    x = torch.empty_like(b)
    if B == 0:
        return x
    G = torch.empty((B, n, m, m), dtype=b.dtype, device=b.device)
    lib = _build.kernels_lib()
    with torch.cuda.device(b.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gpmp2_btsolve(
            D.data_ptr(), U.data_ptr(), b.data_ptr(), lam.data_ptr(),
            x.data_ptr(), G.data_ptr(), B, n, m, int(jacobi_scaling),
            int(b.dtype == torch.float64), ctypes.c_void_p(stream))
    _build.check(rc, "btsolve launch")
    trace.count("launches.k1")
    return x


def batched_block_tridiag_solve(D, U, b, jacobi_scaling: bool = True, lam=None):
    """Solve (H + lam I) x = b: kernel K1 for CUDA tensors, the plain version
    for CPU tensors. D (B, n, m, m), U (B, n-1, m, m), b (B, n, m) ->
    x (B, n, m)."""
    if b.is_cuda:
        return block_tridiag_solve_cuda(D, U, b, jacobi_scaling, lam)
    if b.device.type == "cpu":
        return block_tridiag_solve_torch(D, U, b, jacobi_scaling, lam)
    raise ValueError(f"no solve for device {b.device}")
