"""Seeded random operands for holding the kernels against their plain versions.

Used by `chip_smoke.py` and the card-only tests; numpy only, float64.
"""

from __future__ import annotations

import numpy as np

__all__ = ["random_system", "dh_chain"]


def random_system(B, n, m, seed, damped=True, conditioned=False):
    """Random SPD block-tridiagonal systems (float64 numpy) D (B, n, m, m),
    U (B, n-1, m, m), b (B, n, m), lam (B,). `conditioned` scales the
    blocks by 1/sqrt(m) so that the condition number stays below ~10 at
    every m, up to 34."""
    rng = np.random.default_rng(seed)
    if conditioned:
        A = rng.normal(size=(B, n, m, m)) / np.sqrt(m)
        D = A @ np.swapaxes(A, -1, -2) + 2 * np.eye(m)
        U = 0.2 * rng.normal(size=(B, n - 1, m, m)) / np.sqrt(m)
    else:
        A = rng.normal(size=(B, n, m, m))
        D = A @ np.swapaxes(A, -1, -2) + 10 * np.eye(m)
        U = 0.3 * rng.normal(size=(B, n - 1, m, m))
    b = rng.normal(size=(B, n, m))
    lam = rng.uniform(0.0, 50.0, size=(B,)) if damped else np.zeros(B)
    return D, U, b, lam


def dh_chain(d, S, seed):
    """A random revolute DH chain of d joints with S spheres, as K2's
    operands (float64 numpy): consts (5, d), base (3, 4), scent (S, 3),
    link_ids (S,). Short links keep every output within ~1."""
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(-np.pi, np.pi, d)
    consts = np.stack([rng.uniform(-0.1, 0.1, d), rng.uniform(-0.1, 0.1, d),
                       rng.uniform(-1, 1, d), np.cos(alpha), np.sin(alpha)])
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    base = np.concatenate([Q, rng.uniform(-0.2, 0.2, (3, 1))], axis=1)
    scent = rng.uniform(-0.1, 0.1, (S, 3))
    link_ids = np.sort(rng.integers(0, d, S))
    link_ids[-1] = d - 1
    return consts, base, scent, link_ids
