"""Port's Schur-partitioned and ts-sharded solves (solver/partitioned.py)
against the JAX package's, in float64 on numpy-seeded systems.

The JAX side runs as tests/test_partitioned.py runs it, jitted on the CPU
(its sharded solve on the 8-device virtual CPU mesh of conftest.py). The
port's sharded solve runs here on a one-rank gloo mesh; two ranks are
tests/test_torch_parallel.py's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gpmp2_tpu.parallel import make_mesh as jax_make_mesh
from gpmp2_tpu.solver import partitioned as jax_part
from gpmp2_tpu_torch.ops.btsolve import block_tridiag_solve_torch
from gpmp2_tpu_torch.parallel import make_mesh
from gpmp2_tpu_torch.solver import OptimizerParams, partitioned
from gpmp2_tpu_torch.solver.optimize import _select_solve
from gpmp2_tpu_torch.solver.partitioned import (batched_block_tridiag_solve_ts_sharded,
                                                block_tridiag_solve_matrhs,
                                                block_tridiag_solve_partitioned,
                                                block_tridiag_solve_ts_sharded)


def _system(n, m, seed=0, B=None):
    """tests/test_partitioned.py's systems (with a leading batch when B)."""
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    A = rng.normal(size=lead + (n, m, m))
    D = A @ np.swapaxes(A, -1, -2) + 10 * np.eye(m)
    U = 0.3 * rng.normal(size=lead + (n - 1, m, m))
    b = rng.normal(size=lead + (n, m))
    return D, U, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_partitioned(P):
    return jax.jit(lambda d, u, bb: jax_part.block_tridiag_solve_partitioned(d, u, bb, P))


def test_matrhs_matches_jax_and_each_column():
    D, U, b = _system(9, 4)
    Bm = np.stack([b, 2 * b, -b], axis=-1)
    X = block_tridiag_solve_matrhs(*_t(D, U, Bm)).numpy()
    X_ref = np.asarray(jax.jit(jax_part.block_tridiag_solve_matrhs)(
        jnp.asarray(D), jnp.asarray(U), jnp.asarray(Bm)))
    np.testing.assert_allclose(X, X_ref, rtol=1e-10, atol=1e-12)
    Dt, Ut, bt = _t(D, U, b)
    for k, scale in enumerate([1.0, 2.0, -1.0]):
        col = block_tridiag_solve_torch(Dt[None], Ut[None], scale * bt[None],
                                        jacobi_scaling=False)[0]
        np.testing.assert_allclose(X[..., k], col.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n,m,P", [
    (11, 14, 2),    # the WAM block size
    (23, 4, 4),
    (101, 6, 8),    # long horizon over 8 parts
    (97, 3, 6),     # padding (n is not P * Li + P - 1)
    (15, 2, 1),     # P = 1: K1's sequential sweep
])
def test_partitioned_matches_jax(n, m, P):
    D, U, b = _system(n, m, seed=n + m + P)
    x = block_tridiag_solve_partitioned(*_t(D, U, b), P)
    x_ref = np.asarray(_jax_partitioned(P)(jnp.asarray(D), jnp.asarray(U), jnp.asarray(b)))
    assert x.shape == (n, m)
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-8, atol=1e-8)


def test_partitioned_batch_equals_each_problem():
    """A leading problem axis solves each system as the unbatched call does,
    with and without Jacobi scaling."""
    D, U, b = _system(40, 4, seed=3, B=3)
    for scaling in (True, False):
        x = block_tridiag_solve_partitioned(*_t(D, U, b), 5, jacobi_scaling=scaling)
        for i in range(3):
            xi = block_tridiag_solve_partitioned(*_t(D[i], U[i], b[i]), 5,
                                                 jacobi_scaling=scaling)
            np.testing.assert_allclose(x[i].numpy(), xi.numpy(), rtol=1e-12, atol=1e-14)


def test_partitioned_solves_the_system():
    """The dense residual of the assembled H: catches the transposes of the
    Schur reduction and the padding's couplings."""
    n, m, P = 31, 5, 4
    D, U, b = _system(n, m, seed=5)
    x = block_tridiag_solve_partitioned(*_t(D, U, b), P).numpy()
    H = np.zeros((n * m, n * m))
    for i in range(n):
        H[i * m:(i + 1) * m, i * m:(i + 1) * m] = D[i]
        if i < n - 1:
            H[i * m:(i + 1) * m, (i + 1) * m:(i + 2) * m] = U[i]
            H[(i + 1) * m:(i + 2) * m, i * m:(i + 1) * m] = U[i].T
    assert np.max(np.abs(H @ x.reshape(-1) - b.reshape(-1))) < 1e-8


def test_partitioned_too_short_raises():
    """n <= P - 1 leaves a segment no interior state."""
    D, U, b = _system(3, 2)
    with pytest.raises(ValueError, match="too short"):
        block_tridiag_solve_partitioned(*_t(D, U, b), 4)


@pytest.mark.parametrize("opt_in", [True, False])
def test_long_horizon_dispatch(monkeypatch, opt_in):
    """n = 300: with GPMP2_TPU_PARTITIONED=1 the optimizer's damped solve
    (solver/optimize.py::_select_solve) is the separator solve with
    P = max(2, min(64, n // 64)) = 4, lam folded into D; without it, K1's
    path. Both equal the JAX package's dispatch under the same setting
    (which it takes inside its batched_block_tridiag_solve)."""
    calls = []
    real = partitioned.block_tridiag_solve_partitioned

    def spy(D, U, b, n_parts, jacobi_scaling=True):
        calls.append(n_parts)
        return real(D, U, b, n_parts, jacobi_scaling)

    monkeypatch.setattr(partitioned, "block_tridiag_solve_partitioned", spy)
    if opt_in:
        monkeypatch.setenv("GPMP2_TPU_PARTITIONED", "1")
    else:
        monkeypatch.delenv("GPMP2_TPU_PARTITIONED", raising=False)
    D, U, b = _system(300, 4, seed=11, B=2)
    lam = np.array([0.0, 7.5])
    x = _select_solve(OptimizerParams(), 300)(*_t(D, U, b), lam=torch.from_numpy(lam))
    from gpmp2_tpu.ops.btsolve import batched_block_tridiag_solve as jax_dispatch

    x_ref = np.asarray(jax.jit(lambda d, u, bb, lm: jax_dispatch(d, u, bb, lam=lm))(
        *(jnp.asarray(a) for a in (D, U, b, lam))))
    assert calls == ([4] if opt_in else [])
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-8, atol=1e-8)


@pytest.fixture
def ts_mesh():
    """A one-rank gloo process group on an in-memory store, and a 'ts' mesh
    over it; the group is destroyed after the test."""
    mesh = make_mesh(axis_names=("ts",), device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_ts_sharded_matches_jax_one_rank(ts_mesh):
    """tests/test_partitioned.py's sharded case (n = 127, m = 6, P = 8)
    against the JAX package's solve sharded over 8 virtual CPU devices."""
    n, m, P = 127, 6, 8
    D, U, b = _system(n, m, seed=9)
    x = block_tridiag_solve_ts_sharded(ts_mesh, *_t(D, U, b), P)
    jmesh = jax_make_mesh(axis_names=("ts",))
    x_ref = np.asarray(jax.jit(lambda d, u, bb: jax_part.block_tridiag_solve_ts_sharded(
        jmesh, d, u, bb, P))(jnp.asarray(D), jnp.asarray(U), jnp.asarray(b)))
    np.testing.assert_allclose(x.numpy(), x_ref, rtol=1e-8, atol=1e-8)
    x_k1 = block_tridiag_solve_torch(*_t(D[None], U[None], b[None]))[0]
    np.testing.assert_allclose(x.numpy(), x_k1.numpy(), rtol=1e-8, atol=1e-8)


def test_ts_sharded_batched_one_rank(ts_mesh):
    """The batched form on a (dp, ts) = (1, 1) mesh equals the partitioned
    solve, scaled and unscaled; n_parts below 2 raises."""
    mesh = make_mesh(shape=(1, 1), axis_names=("dp", "ts"), device="cpu")
    D, U, b = _system(50, 4, seed=4, B=3)
    for scaling in (True, False):
        x = batched_block_tridiag_solve_ts_sharded(mesh, *_t(D, U, b), 6,
                                                   jacobi_scaling=scaling)
        x_ref = block_tridiag_solve_partitioned(*_t(D, U, b), 6, jacobi_scaling=scaling)
        np.testing.assert_allclose(x.numpy(), x_ref.numpy(), rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError, match="must be >= 2"):
        batched_block_tridiag_solve_ts_sharded(mesh, *_t(D, U, b), 1)


def test_make_mesh_checks(ts_mesh, monkeypatch):
    """The world size is one rank here; a CUDA mesh without a card raises
    rather than falling back to the CPU."""
    assert ts_mesh.mesh_dim_names == ("ts",) and ts_mesh.size() == 1
    with pytest.raises(ValueError, match="n_devices=2"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(shape=(2, 1), axis_names=("dp", "ts"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(device="cuda")
