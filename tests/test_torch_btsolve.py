"""Port's block-tridiagonal solve (plain twin of kernel K1) vs the JAX package.

The JAX side runs as its own tests run it: the scan solver under vmap in
float64, and the Pallas kernel in interpret mode in float32
(tests/test_pallas_ops.py). Inputs come from a seeded numpy generator.
The kernel itself is held against it on a card in
test_torch_kernels_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.ops.btsolve import block_tridiag_solve_pallas
from gpmp2_tpu.solver.blocktridiag import block_tridiag_solve
from gpmp2_tpu_torch.ops.btsolve import (batched_block_tridiag_solve,
                                         block_tridiag_solve_torch)


def _random_system(B, n, m, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, m, m))
    D = A @ np.swapaxes(A, -1, -2) + 10 * np.eye(m)
    U = 0.3 * rng.normal(size=(B, n - 1, m, m))
    b = rng.normal(size=(B, n, m))
    lam = rng.uniform(0.0, 50.0, size=(B,))
    return tuple(a.astype(dtype) for a in (D, U, b, lam))


@functools.lru_cache(maxsize=None)
def _jax_scan_fn(scaling):
    """The JAX scan solver under vmap, jitted once per scaling flag (its
    eager op-by-op dispatch takes seconds per call)."""
    return jax.jit(jax.vmap(
        lambda d, u, bb: block_tridiag_solve(d, u, bb, jacobi_scaling=scaling)))


def _jax_scan(D, U, b, lam, scaling):
    m = D.shape[-1]
    Dd = D + lam[:, None, None, None] * np.eye(m)
    return np.asarray(_jax_scan_fn(scaling)(jnp.asarray(Dd), jnp.asarray(U), jnp.asarray(b)))


@pytest.mark.parametrize("scaling", [True, False])
@pytest.mark.parametrize("damped", [True, False])
@pytest.mark.parametrize("B,n,m", [(5, 11, 14), (3, 4, 6), (9, 5, 6)])
def test_plain_matches_jax_scan(B, n, m, damped, scaling):
    D, U, b, lam = _random_system(B, n, m, seed=B + n + m)
    if not damped:
        lam = np.zeros_like(lam)
    x_ref = _jax_scan(D, U, b, lam, scaling)
    D, U, b, lam = (torch.from_numpy(a) for a in (D, U, b, lam))
    x = block_tridiag_solve_torch(D, U, b, jacobi_scaling=scaling, lam=lam)
    # float64, same recurrences; differences are reassociation only
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("B,n,m", [(5, 11, 14), (9, 5, 6)])
def test_plain_matches_pallas_interpret(B, n, m):
    D, U, b, lam = _random_system(B, n, m, seed=7, dtype=np.float32)
    x_pal = block_tridiag_solve_pallas(
        jnp.asarray(D), jnp.asarray(U), jnp.asarray(b), lam=jnp.asarray(lam),
        interpret=True)
    D, U, b, lam = (torch.from_numpy(a) for a in (D, U, b, lam))
    x = block_tridiag_solve_torch(D, U, b, lam=lam)
    # float32 on both sides; tolerance of tests/test_pallas_ops.py
    np.testing.assert_allclose(x.numpy(), np.asarray(x_pal), rtol=2e-4, atol=2e-5)


def test_dispatch_takes_plain_on_cpu():
    D, U, b, lam = (torch.from_numpy(a) for a in _random_system(4, 6, 8, seed=3))
    x = batched_block_tridiag_solve(D, U, b, lam=lam)
    np.testing.assert_array_equal(
        x.numpy(), block_tridiag_solve_torch(D, U, b, lam=lam).numpy())


def test_non_pd_block_gives_non_finite_lane():
    """A non-positive pivot poisons only its own lane, as the JAX kernel's
    unrolled Cholesky does; the optimizer rejects such steps."""
    D, U, b, lam = (torch.from_numpy(a) for a in _random_system(3, 4, 6, seed=5))
    D[1, 2] = -D[1, 2]
    x = block_tridiag_solve_torch(D, U, b, jacobi_scaling=False)
    finite = torch.isfinite(x).reshape(3, -1).all(-1)
    assert finite.tolist() == [True, False, True]

