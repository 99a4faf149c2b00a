"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports only torch, numpy and the port, so it runs where JAX is not
installed. Every test is marked `cuda` and skips without an NVIDIA GPU:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

The plain versions run in float64 on the same (rounded) inputs.
"""

import numpy as np
import pytest
import torch

from gpmp2_tpu_torch.ops.btsolve import (block_tridiag_solve_cuda,
                                         block_tridiag_solve_torch)
from gpmp2_tpu_torch.ops.fk_arm import (arm_fk_spheres_cuda, fk_spheres_torch,
                                        structure_arrays)
from gpmp2_tpu_torch.robots import generate_arm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _random_system(B, n, m, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, m, m))
    D = A @ np.swapaxes(A, -1, -2) + 10 * np.eye(m)
    U = 0.3 * rng.normal(size=(B, n - 1, m, m))
    b = rng.normal(size=(B, n, m))
    lam = rng.uniform(0.0, 50.0, size=(B,))
    return D, U, b, lam


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,n,m,scaling", [
    (torch.float32, 2048, 11, 14, True), (torch.float32, 37, 5, 6, True),
    (torch.float32, 100, 7, 4, False), (torch.float64, 64, 11, 14, True),
    (torch.float64, 9, 3, 34, True)])
def test_btsolve_kernel_matches_plain(cuda_device, dtype, B, n, m, scaling):
    D, U, b, lam = (torch.as_tensor(a, dtype=dtype, device=cuda_device)
                    for a in _random_system(B, n, m, seed=11))
    x = block_tridiag_solve_cuda(D, U, b, scaling, lam)
    x_ref = block_tridiag_solve_torch(D.double(), U.double(), b.double(),
                                      scaling, lam.double())
    # float32: relative to the solution's scale (random systems with
    # condition ~1e2 after scaling); float64: same recurrences, reassociated
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((x.double() - x_ref).abs().max()) <= tol * float(x_ref.abs().max())


@pytest.mark.cuda
def test_btsolve_kernel_rejects_odd_block(cuda_device):
    D, U, b, lam = (torch.as_tensor(a, device=cuda_device)
                    for a in _random_system(4, 3, 5, seed=1))
    with pytest.raises(ValueError):
        block_tridiag_solve_cuda(D, U, b, True, lam)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,N", [(torch.float32, 206848), (torch.float32, 1000),
                                     (torch.float64, 1000)])
def test_fk_arm_kernel_matches_plain(cuda_device, dtype, N):
    model = generate_arm("WAMArm", dtype=torch.float64, device=cuda_device)
    q = torch.as_tensor(np.random.default_rng(N).uniform(-2, 2, (N, 7)),
                        dtype=dtype, device=cuda_device)
    c, J = arm_fk_spheres_cuda(*structure_arrays(model, dtype, cuda_device), q)
    c_ref, J_ref = fk_spheres_torch(
        *structure_arrays(model, torch.float64, cuda_device), q.double())
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((c.double() - c_ref).abs().max()) <= tol
    assert float((J.double() - J_ref).abs().max()) <= tol


def _lookup_case(dim, worlds, n, dtype, device, seed=3):
    """A random field, its packed and raw tables, and points over the grid
    and a margin outside it, with one query in each case set to NaN."""
    from gpmp2_tpu_torch.obstacle.sdf import (PlanarSDF, SignedDistanceField,
                                              pack_planar_sdf, pack_sdf)

    rng = np.random.default_rng(seed)
    grid = (40, 50) if dim == 2 else (20, 30, 40)
    data = rng.normal(size=((worlds,) if worlds else ()) + grid)
    origin = np.array([-0.5, -1.0, 0.25][:dim])
    cell = 0.05
    cls, pack = (PlanarSDF, pack_planar_sdf) if dim == 2 else (SignedDistanceField, pack_sdf)
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    sdf = pack(cls(f(origin), f(cell), f(data)))
    ext = np.array(grid[::-1]) * cell
    pts = origin + rng.uniform(-0.1, 1.1, size=(max(worlds, 1) * n, dim)) * ext
    pts[0, 0] = np.nan
    return sdf, f(pts)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("worlds", [0, 16])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sdf_lookup_kernel_matches_plain(cuda_device, dim, worlds, packed, dtype):
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda, sdf_lookup_torch

    sdf, pts = _lookup_case(dim, worlds, 5000, dtype, cuda_device)
    k = 2 ** dim
    table = sdf.packed.reshape(-1, k) if packed else sdf.data.reshape(-1)
    qpw = 5000 if worlds else 0
    got = sdf_lookup_cuda(pts, table, sdf.origin, sdf.cell_size, sdf.grid, qpw)
    ref = sdf_lookup_torch(pts, table, sdf.origin, sdf.cell_size, sdf.grid, qpw)
    # same arithmetic in the same dtype on the same inputs; only FMA
    # contraction differs, so a few ulps of the field's scale
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert torch.equal(got[-1], ref[-1])
    # the NaN x coordinate reaches dist (and the gradients that read fx)
    assert torch.isnan(got[0][0]) and torch.isnan(ref[0][0])
    for g, r in zip(got[:-1], ref[:-1]):
        fin = ~torch.isnan(r)
        assert torch.equal(~torch.isnan(g), fin)
        scale = float(r[fin].abs().max())
        assert float((g[fin] - r[fin]).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_sdf_lookup_kernel_rejects_misaligned_table(cuda_device):
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda

    sdf, pts = _lookup_case(3, 0, 100, torch.float32, cuda_device)
    buf = torch.empty(sdf.packed.numel() + 1, dtype=torch.float32, device=cuda_device)
    rows = buf[1:].view(-1, 8)
    rows.copy_(sdf.packed)
    with pytest.raises(ValueError, match="16-byte"):
        sdf_lookup_cuda(pts, rows, sdf.origin, sdf.cell_size, sdf.grid)
