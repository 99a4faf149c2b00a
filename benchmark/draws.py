"""Endpoint draws from the seed, as the configuration's `draw` names them.

- "rejection": bench.py's sampler (main_path_endpoints): the base start
  and goal plus sigma N(0, 1), drawn 2 n at a time and kept where every
  sphere is free (the reference's collision cost below 1e-6), starts
  first, then goals.
- "uniform": bench_suite.py's MobileBaseSE2 draw: each coordinate of the
  starts, then of the goals, uniform in its box, coordinate by coordinate.

Both return numpy (n, d) starts and goals in float64.
"""

import numpy as np
import torch


def rejection(rng, n, draw, free):
    """`free(q)` -> bool mask of configurations q (m, d) that collide with
    nothing."""
    def side(base):
        base = np.asarray(base, np.float64)
        out = []
        while len(out) < n:
            cand = base + draw["sigma"] * rng.normal(size=(2 * n, base.shape[0]))
            out.extend(cand[free(cand)][: n - len(out)])
        return np.stack(out)
    return side(draw["start"]), side(draw["goal"])


def uniform(rng, n, draw, free=None):
    def side(lo, hi):
        return np.stack([rng.uniform(a, b, n) for a, b in zip(lo, hi)], -1)
    return side(draw["start_lo"], draw["start_hi"]), side(draw["goal_lo"], draw["goal_hi"])


def endpoints(seed, n, draw, problem):
    """n (start, goal) pairs for `seed`; `problem` is the reference's
    graph, whose collision cost decides which draws are free."""
    rng = np.random.default_rng(seed)
    device = problem.field.data.device

    def free(q):
        qt = torch.as_tensor(q, dtype=torch.float64, device=device)
        return (problem.collision_cost(qt[:, None, :]) < 1e-6).cpu().numpy()
    return globals()[draw["kind"]](rng, n, draw, free)
