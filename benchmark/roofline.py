"""The least time the H100 could take for a kernel's call: the larger of
its bytes over the memory rate and its operations over the peak rate
(copied from chip_smoke.py's bound, k1_bound, k2_bound and k3_bound,
which PERF.md's kernel table uses). Published peaks of one H100 SXM
(NVIDIA's data sheet): 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside
the tensor cores."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound(nbytes, flops, flops_per_s=F32_FLOPS):
    """Milliseconds: bytes over the memory rate or operations over the peak,
    whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s) * 1e3


def k1_bound(B, n, m, itemsize=4):
    """K1 (block-tridiagonal damped solve) for B systems of n blocks of m:
    D, U, b and lambda read once, x written once; per block a Cholesky
    (m^3 / 3), the [U | z] solve and U^T X carry (4 m^2 (m + 1)) and the
    back substitution (2 m^2)."""
    nbytes = itemsize * B * (n * m * m + (n - 1) * m * m + 2 * n * m + 1)
    return bound(nbytes, B * n * (m**3 / 3 + 4 * m * m * (m + 1) + 2 * m * m))


def k2_bound(N, d, S):
    """K2 (arm FK with sphere centres and Jacobians) for N float32
    configurations of d joints and S spheres: the configurations read
    once, the centres and Jacobians written once; the chain's and the
    spheres' operations."""
    return bound(4 * N * (d + S * 3 + S * 3 * d), N * (40 * d + S * (12 + 9 * d)))


def k3_bound(N, dim, rows):
    """K3 (SDF lookup on a packed float32 table) for N queries in `dim`
    dimensions that touch `rows` distinct packed rows: the points read
    once, each row (4 bytes a corner) read once, the dim + 1 outputs and
    the in-range mask written once; the interpolation's operations (120
    a query in 3D, 40 in 2D)."""
    row_bytes = 4 * 2 ** dim
    return bound(N * dim * 4 + rows * row_bytes + N * ((dim + 1) * 4 + 1),
                 N * (120 if dim == 3 else 40))


def distinct_rows(points, origin, cell_size, sizes):
    """The distinct cells (low corners, clamped as the lookup clamps them)
    that queries `points` (N, >= dim) read on a grid of `sizes` (x, y[, z])."""
    import torch

    dim = len(sizes)
    c = ((points[:, :dim].double() - torch.as_tensor(origin, dtype=torch.float64,
                                                     device=points.device))
         / cell_size)
    key = torch.zeros(points.shape[0], dtype=torch.int64, device=points.device)
    for k in reversed(range(dim)):
        i = c[:, k].clamp(0.0, sizes[k] - 1.0).floor().long().clamp(0, sizes[k] - 2)
        key = key * sizes[k] + i
    return int(torch.unique(key).numel())
