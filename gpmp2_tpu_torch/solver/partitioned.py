"""Trajectory-axis-parallel block-tridiagonal solve (Schur domain
decomposition).

Port of gpmp2_tpu/solver/partitioned.py. The n states of a trajectory
split into P segments separated by P - 1 separator states:

  1. each segment solves its local block-tridiagonal system against
     [E_first | E_last | b] (block-Thomas with a matrix right-hand side);
  2. the Schur complement over the separators is again block-tridiagonal,
     P - 1 blocks long, and goes through kernel K1
     (ops/btsolve.py::batched_block_tridiag_solve, no scaling);
  3. each segment back-substitutes against its two separator values.

The critical path drops from n block steps to n/P + P. Exact: the same
answer as K1's sequential sweep up to rounding.

The segment stage is plain torch (XLA work in the JAX package): a loop
over the Li steps of a segment, batched over the problems and the
segments. `block_tridiag_solve_partitioned` runs every segment in one
process; the ts-sharded forms give each rank of a mesh's 'ts' dim its
P / ts segments, gather the segments' first and last rows (all the Schur
system needs) with one all_gather, solve the separator system on every
rank and gather the solution, so that every rank holds the whole x.

The unbatched public functions keep the JAX package's shapes: D (n, m, m),
U (n - 1, m, m), b (n, m) -> x (n, m). The batched forms take a leading
problem axis B.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.btsolve import batched_block_tridiag_solve

__all__ = [
    "block_tridiag_solve_matrhs",
    "block_tridiag_solve_partitioned",
    "block_tridiag_solve_ts_sharded",
    "batched_block_tridiag_solve_ts_sharded",
]


def _chol_solve(C, rhs):
    """C^-1 rhs through a lower Cholesky factor; a non-positive pivot gives
    NaN for that system, as the JAX package's `jnp.linalg.cholesky` does."""
    L, info = torch.linalg.cholesky_ex(C)
    L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
    return torch.cholesky_solve(rhs, L)


def block_tridiag_solve_matrhs(D, U, B):
    """Block-Thomas with a matrix right-hand side: D (..., n, m, m),
    U (..., n-1, m, m), B (..., n, m, k) -> X (..., n, m, k). Leading
    dims are independent systems."""
    n, m = D.shape[-3], D.shape[-1]
    PC = torch.zeros_like(D[..., 0, :, :])
    Pz = torch.zeros_like(B[..., 0, :, :])
    W, G = [], []
    for i in range(n):
        Z = B[..., i, :, :] - Pz
        if i == n - 1:
            W.append(_chol_solve(D[..., i, :, :] - PC, Z))
            break
        U_i = U[..., i, :, :]
        X = _chol_solve(D[..., i, :, :] - PC, torch.cat([U_i, Z], dim=-1))
        G.append(X[..., :m])
        W.append(X[..., m:])
        carry = U_i.mT @ X
        PC, Pz = carry[..., :m], carry[..., m:]
    xs = [W[-1]]
    for i in range(n - 2, -1, -1):
        xs.append(W[i] - G[i] @ xs[-1])
    return torch.stack(xs[::-1], dim=-3)


def _segment_stage(D_seg, U_seg, b_seg):
    """Local solves of segments against [E_first | E_last | b].

    D_seg (..., Li, m, m), U_seg (..., Li-1, m, m), b_seg (..., Li, m).
    Returns Y (..., Li, m, 2m+1): columns 0:m = H^-1 E_first, m:2m =
    H^-1 E_last, the last = H^-1 b."""
    Li, m = D_seg.shape[-3], D_seg.shape[-1]
    RHS = D_seg.new_zeros(b_seg.shape[:-1] + (m, 2 * m + 1))
    eye = torch.eye(m, dtype=D_seg.dtype, device=D_seg.device)
    RHS[..., 0, :, :m] = eye
    RHS[..., Li - 1, :, m:2 * m] = eye
    RHS[..., -1] = b_seg
    return block_tridiag_solve_matrhs(D_seg, U_seg, RHS)


def _plan(n, P, device):
    """The partition of n states into P segments of Li interior states and
    P - 1 separators, padded to P * Li + P - 1: (Li, n_pad, idx_int (P, Li),
    idx_u (P, Li-1), sep (P-1,)) with the indices as int64 tensors."""
    Li = -(-(n - (P - 1)) // P)  # ceil interior length
    if Li < 1:
        raise ValueError(f"n={n} too short for {P} partitions (need n >= 2P-1)")
    stride = Li + 1
    ar = lambda k: torch.arange(k, device=device)  # noqa: E731
    seg_start = stride * ar(P)[:, None]
    return (Li, P * Li + (P - 1), seg_start + ar(Li), seg_start + ar(Li - 1),
            stride * ar(P)[1:] - 1)


def _partition(D, U, b, n_parts):
    """Split batched (D, U, b) into P segments and P - 1 separators, padding
    n up to P * Li + (P - 1) with identity diagonal blocks (decoupled, so
    x = 0 there). D (B, n, m, m), U (B, n-1, m, m), b (B, n, m)."""
    B, n, m = b.shape
    P = n_parts
    Li, n_pad, idx_int, idx_u, sep = _plan(n, P, D.device)
    pad = n_pad - n
    if pad:
        eye = torch.eye(m, dtype=D.dtype, device=D.device).expand(B, pad, m, m)
        D = torch.cat([D, eye], dim=1)
        b = torch.cat([b, b.new_zeros((B, pad, m))], dim=1)
    # U padded with zeros to n_pad: the couplings into the padding and the
    # last state's (none) read zeros
    U_full = torch.cat([U, U.new_zeros((B, n_pad - (n - 1), m, m))], dim=1)
    D_seg = D[:, idx_int]  # (B, P, Li, m, m)
    b_seg = b[:, idx_int]  # (B, P, Li, m)
    U_seg = U_full[:, idx_u]  # (B, P, Li-1, m, m)
    # couplings: a_t = U[sep_t - 1] (segment t's last state -> separator t),
    #            c_t = U[sep_t]     (separator t -> segment t+1's first state)
    a = U_full[:, sep - 1]  # (B, P-1, m, m)
    c = U_full[:, sep]
    return (D_seg, U_seg, b_seg, a, c, D[:, sep], b[:, sep], idx_int, sep, n, Li, P)


def _schur_reduce(Y, a, c, D_sep, b_sep):
    """The (P-1)-block separator system from the segments' solutions
    Y (B, P, Li, m, 2m+1); only Y[:, :, 0] and Y[:, :, -1] are read."""
    m = D_sep.shape[-1]
    Ff_f = Y[:, :, 0, :, :m]  # (H^-1)[first, first]
    Fl_f = Y[:, :, 0, :, m:2 * m]  # (H^-1)[first, last]
    Fl_l = Y[:, :, -1, :, m:2 * m]  # (H^-1)[last, last]
    y_f = Y[:, :, 0, :, -1]  # (B, P, m)
    y_l = Y[:, :, -1, :, -1]
    # diag: D_sep - a^T (H_t^-1)[l,l] a - c (H_{t+1}^-1)[f,f] c^T
    SD = D_sep - a.mT @ Fl_l[:, :-1] @ a - c @ Ff_f[:, 1:] @ c.mT
    # off-diag t -> t+1 through segment t+1: -c_t (H^-1)[f,l] a_{t+1}
    SU = -c[:, :-1] @ Fl_f[:, 1:-1] @ a[:, 1:]
    Sb = (b_sep - (a.mT @ y_l[:, :-1, :, None])[..., 0]
          - (c @ y_f[:, 1:, :, None])[..., 0])
    return SD.contiguous(), SU.contiguous(), Sb.contiguous()


def _back_substitute(Y, a, c, x_sep, first=0):
    """x_I of segments first .. first + Y.shape[1] - 1:
    y - (H^-1 E_first) c^T x_left - (H^-1 E_last) a x_right."""
    B, Pl, Li, m, _ = Y.shape
    zero = x_sep.new_zeros((B, 1, m))
    gl = torch.cat([zero, (c.mT @ x_sep[..., None])[..., 0]], dim=1)[:, first:first + Pl]
    gr = torch.cat([(a @ x_sep[..., None])[..., 0], zero], dim=1)[:, first:first + Pl]
    Ff, Fl, y = Y[..., :m], Y[..., m:2 * m], Y[..., -1]
    return y - (Ff @ gl[:, :, None, :, None])[..., 0] - (Fl @ gr[:, :, None, :, None])[..., 0]


def _jacobi_scale(D, U, b):
    """Symmetric scaling by s = rsqrt(max(diag(D), 1e-30)), batched."""
    s = torch.rsqrt(torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1), min=1e-30))
    D = D * s[..., :, None] * s[..., None, :]
    U = U * s[:, :-1, :, None] * s[:, 1:, None, :]
    return D, U, b * s, s


def _assemble(x_int, x_sep, idx_int, sep, n, Li, P):
    """x (B, n, m) from the interior and separator solutions."""
    B, m = x_sep.shape[0], x_sep.shape[-1]
    x = x_sep.new_zeros((B, P * Li + (P - 1), m))
    x[:, idx_int.reshape(-1)] = x_int.reshape(B, -1, m)
    x[:, sep] = x_sep
    return x[:, :n]


def block_tridiag_solve_partitioned(D, U, b, n_parts: int, jacobi_scaling: bool = True):
    """Exact H x = b through a P-way separator decomposition in one process.
    D (n, m, m), U (n-1, m, m), b (n, m) -> x (n, m); with a leading
    problem axis, (B, n, m, m) ... -> (B, n, m) solves B systems together
    (the port's counterpart of jax.vmap over this function).

    Requires n >= 2 * n_parts - 1 (each segment needs one interior state).
    n_parts <= 1 takes K1's sequential sweep. The separator system goes
    through K1 too: on CUDA tensors the block size must be one K1 takes
    (even, at most 36)."""
    if b.dim() == 2:
        return block_tridiag_solve_partitioned(D[None], U[None], b[None], n_parts,
                                               jacobi_scaling)[0]
    if n_parts <= 1:
        return batched_block_tridiag_solve(D.contiguous(), U.contiguous(), b.contiguous(),
                                           jacobi_scaling=jacobi_scaling)
    s = None
    if jacobi_scaling:
        D, U, b, s = _jacobi_scale(D, U, b)
    (D_seg, U_seg, b_seg, a, c, D_sep, b_sep,
     idx_int, sep, n, Li, P) = _partition(D, U, b, n_parts)
    Y = _segment_stage(D_seg, U_seg, b_seg)  # (B, P, Li, m, 2m+1)
    SD, SU, Sb = _schur_reduce(Y, a, c, D_sep, b_sep)
    x_sep = batched_block_tridiag_solve(SD, SU, Sb, jacobi_scaling=False)  # (B, P-1, m)
    x = _assemble(_back_substitute(Y, a, c, x_sep), x_sep, idx_int, sep, n, Li, P)
    return x * s if s is not None else x


def _all_gather(t, group, dim):
    """The tensors `t` of every rank of `group`, concatenated along `dim` in
    the group's rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def batched_block_tridiag_solve_ts_sharded(mesh, D, U, b, n_parts: int,
                                           ts_axis: str = "ts",
                                           jacobi_scaling: bool = True):
    """Batched trajectory-axis-sharded exact solve over the 'ts' dim of a
    DeviceMesh (parallel/mesh.py::make_mesh): the form the optimizer's damped
    solve takes (OptimizerParams.ts_mesh / ts_parts).

    D (B, n, m, m), U (B, n-1, m, m), b (B, n, m) -> x (B, n, m), the same
    on every rank of the ts dim. The batch is this rank's lanes already
    (shard_problems over the 'dp' dim), so the JAX signature's `dp_axis`,
    with which the solve itself sharded the batch, is dropped. Each rank of
    `ts_axis` solves its n_parts / ts segments; one all_gather carries the
    segments' first and last rows; every rank solves the (P-1)-block
    separator system (K1) and back-substitutes its own segments; a second
    all_gather assembles x. Every rank of the ts dim must call this with
    the same shapes."""
    ts = mesh.size(mesh.mesh_dim_names.index(ts_axis))
    if n_parts < 2 or n_parts % ts:
        raise ValueError(f"n_parts={n_parts} must be >= 2 and divide over mesh axis "
                         f"'{ts_axis}' (size {ts})")
    s = None
    if jacobi_scaling:
        D, U, b, s = _jacobi_scale(D, U, b)
    (D_seg, U_seg, b_seg, a, c, D_sep, b_sep,
     idx_int, sep, n, Li, P) = _partition(D, U, b, n_parts)
    Pl = P // ts
    first = mesh.get_local_rank(ts_axis) * Pl
    mine = slice(first, first + Pl)
    group = mesh.get_group(ts_axis)
    Y = _segment_stage(D_seg[:, mine], U_seg[:, mine], b_seg[:, mine])  # (B, Pl, Li, m, 2m+1)
    # the separator system reads each segment's first and last rows only
    ends = _all_gather(torch.stack([Y[:, :, 0], Y[:, :, -1]], dim=2), group, dim=1)
    SD, SU, Sb = _schur_reduce(ends, a, c, D_sep, b_sep)
    x_sep = batched_block_tridiag_solve(SD, SU, Sb, jacobi_scaling=False)
    x_int = _all_gather(_back_substitute(Y, a, c, x_sep, first), group, dim=1)
    x = _assemble(x_int, x_sep, idx_int, sep, n, Li, P)
    return x * s if s is not None else x


def block_tridiag_solve_ts_sharded(mesh, D, U, b, n_parts: int, axis: str = "ts",
                                   jacobi_scaling: bool = True):
    """Trajectory-axis-sharded exact solve of one system over the mesh dim
    `axis`: D (n, m, m), U (n-1, m, m), b (n, m) -> x (n, m) on every rank
    of that dim (batched_block_tridiag_solve_ts_sharded at B = 1). n_parts
    must be a multiple of the dim's size."""
    return batched_block_tridiag_solve_ts_sharded(
        mesh, D[None], U[None], b[None], n_parts, ts_axis=axis,
        jacobi_scaling=jacobi_scaling)[0]
