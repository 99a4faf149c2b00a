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
