"""The port's SDF packing and lookups against the JAX package, on the CPU.

Small fields (a few thousand cells), made from a seed with numpy, go
through both packages: the packed tables must be bit-equal, and the
lookups (2D and 3D, packed and raw, one shared world or one per problem)
must agree in float64 at rtol 1e-12. On a dyadic grid, points exactly on
the top faces, just outside the grid and NaN give the same distance,
gradient and in-range mask.

The TPU row-gather kernels P1-P9 use TPU-only DMA semaphores and do not
run in interpret mode on a CPU; their function, the row gather
`jnp.take(packed.reshape(-1, 8|4), idx, axis=0)`, is what the JAX lookup
runs on a packed table, and the gather test holds the port's rows to it.
On the CPU the port runs kernel K3's plain version (ops/sdf_lookup.py);
tests/test_torch_kernels_cuda.py holds the kernel to it on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.obstacle import sdf as jsdf_mod
from gpmp2_tpu_torch.obstacle import sdf as tsdf_mod
from gpmp2_tpu_torch.utils.convert import planar_sdf_from_numpy, sdf_from_numpy

GRID = {2: (13, 17), 3: (7, 9, 11)}  # (rows, cols), (nz, rows, cols)
CELL = 0.125  # dyadic: cell coordinates of dyadic points are exact
W = 3  # worlds of a per-problem field


def field(dim, worlds, seed=0):
    shape = ((worlds,) if worlds else ()) + GRID[dim]
    return np.random.default_rng(seed).normal(size=shape)


def origin(dim):
    return np.array([-0.75, -1.0, 0.25][:dim])


def both_sdfs(dim, worlds, packed):
    """The JAX and port SDFs of one field (float64, CPU)."""
    data = field(dim, worlds)
    if dim == 2:
        j = jsdf_mod.PlanarSDF(jnp.asarray(origin(2)), jnp.asarray(CELL), jnp.asarray(data))
        t = planar_sdf_from_numpy(origin(2), CELL, data, dtype=torch.float64, device="cpu")
        if packed:
            j, t = jsdf_mod.pack_planar_sdf(j), tsdf_mod.pack_planar_sdf(t)
    else:
        j = jsdf_mod.SignedDistanceField(jnp.asarray(origin(3)), jnp.asarray(CELL),
                                         jnp.asarray(data))
        t = sdf_from_numpy(origin(3), CELL, data, dtype=torch.float64, device="cpu")
        if packed:
            j, t = jsdf_mod.pack_sdf(j), tsdf_mod.pack_sdf(t)
    return j, t


def query_points(dim, n, worlds, seed=1):
    """Points over the grid and a margin outside it: (n, dim) or (W, n, dim)."""
    rng = np.random.default_rng(seed)
    sizes = np.array(GRID[dim][::-1]) * CELL  # extents along x, y[, z]
    shape = ((worlds,) if worlds else ()) + (n, dim)
    return origin(dim) + rng.uniform(-0.1, 1.1, size=shape) * sizes


def jax_lookup(jsdf, pts, worlds):
    """JAX's component lookup; a per-problem field is vmapped over worlds."""
    dim = pts.shape[-1]
    fn = (jsdf_mod.planar_sdf_lookup_components if dim == 2
          else jsdf_mod.sdf_lookup_components)

    def one(data, packed, p):
        s = jsdf._replace(data=data, packed=packed)
        return fn(s, *(p[..., k] for k in range(dim)))

    p = jnp.asarray(pts)
    if not worlds:
        return one(jsdf.data, jsdf.packed, p)
    return jax.vmap(one, in_axes=(0, None if jsdf.packed is None else 0, 0))(
        jsdf.data, jsdf.packed, p)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("worlds", [0, W])
def test_pack_bit_equal_to_jax(dim, worlds):
    j, t = both_sdfs(dim, worlds, packed=True)
    want = np.asarray(j.packed)
    assert t.packed.shape == want.shape == field(dim, worlds).shape[:-dim] + (
        int(np.prod(GRID[dim])), 2 ** dim)
    np.testing.assert_array_equal(t.packed.numpy(), want)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("worlds", [0, W])
@pytest.mark.parametrize("packed", [True, False])
def test_lookup_matches_jax(dim, worlds, packed):
    j, t = both_sdfs(dim, worlds, packed)
    pts = query_points(dim, 400, worlds)
    ref = jax_lookup(j, pts, worlds)
    fn = (tsdf_mod.planar_sdf_lookup_components if dim == 2
          else tsdf_mod.sdf_lookup_components)
    got = fn(t, *(torch.from_numpy(pts[..., k]) for k in range(dim)))
    assert len(got) == dim + 2
    ok = np.asarray(ref[-1])
    assert ok.any() and not ok.all()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("packed", [True, False])
def test_lookup_edges_match_jax(dim, packed):
    """Exact top-face, low-face and corner points (in range), points one
    step outside each face (out of range), and NaN coordinates."""
    j, t = both_sdfs(dim, 0, packed)
    top = origin(dim) + (np.array(GRID[dim][::-1]) - 1) * CELL
    lo = origin(dim)
    pts = [lo, top, 0.5 * (lo + top)]
    for k in range(dim):
        for face, step in ((top, CELL / 64), (lo, -CELL / 64)):
            on = 0.5 * (lo + top)
            on[k] = face[k]
            out = on.copy()
            out[k] += step
            pts += [on, out]
    nan = 0.5 * (lo + top)
    nan[0] = np.nan
    pts.append(nan)
    pts = np.array(pts)
    ref = jax_lookup(j, pts, 0)
    got = tsdf_mod.sdf_lookup_points(t, torch.from_numpy(pts))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-14)
    # the point form, gradient stacked (x, y[, z])
    jfn, tfn = ((jsdf_mod.planar_sdf_lookup, tsdf_mod.planar_sdf_lookup) if dim == 2
                else (jsdf_mod.sdf_lookup, tsdf_mod.sdf_lookup))
    for g, r in zip(tfn(t, torch.from_numpy(pts)), jfn(j, jnp.asarray(pts))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-14)
    expect_ok = [True, True, True] + [True, False] * (2 * dim) + [False]
    assert np.asarray(ref[-1]).tolist() == expect_ok
    assert np.isnan(got[0][-1].item())


@pytest.mark.parametrize("dim", [2, 3])
def test_gather_rows_match_jax_take(dim):
    """The P-kernels' function on the packed tables of a per-problem field:
    the port's row gather against jnp.take on the JAX table."""
    j, t = both_sdfs(dim, W, packed=True)
    k = 2 ** dim
    idx = np.random.default_rng(2).integers(0, W * int(np.prod(GRID[dim])), 1000)
    want = jnp.take(j.packed.reshape(-1, k), jnp.asarray(idx), axis=0)
    got = t.packed.reshape(-1, k)[torch.from_numpy(idx)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bad", ["origin", "grid", "packed", "worlds_vs_points"])
def test_bad_fields_raise(bad):
    data = field(3, W)
    o = origin(3)
    if bad == "origin":
        o = origin(2)
    elif bad == "grid":
        data = data[..., :1]
    with pytest.raises(ValueError):
        sdf = sdf_from_numpy(o, CELL, data, dtype=torch.float64, device="cpu")
        if bad == "packed":
            sdf = tsdf_mod.pack_sdf(sdf)
            tsdf_mod.SignedDistanceField(sdf.origin, sdf.cell_size, sdf.data,
                                         sdf.packed[..., :4])
        tsdf_mod.sdf_lookup_points(sdf, torch.zeros(W + 1, 5, 3, dtype=torch.float64))
