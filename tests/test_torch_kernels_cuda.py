"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports only torch, numpy and the port, so it runs where JAX is not
installed. Every test is marked `cuda` and skips without an NVIDIA GPU:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

The plain versions run in float64 on the same (rounded) inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpmp2_tpu_torch.ops.btsolve import (block_tridiag_solve_cuda,
                                         block_tridiag_solve_torch)
from gpmp2_tpu_torch.ops.btsolve import launch_plan as bt_launch_plan
from gpmp2_tpu_torch.ops.fk_arm import (arm_fk_spheres_cuda, fk_spheres_torch,
                                        structure_arrays)
from gpmp2_tpu_torch.ops.fk_arm import launch_plan as fk_launch_plan
from gpmp2_tpu_torch.robots import generate_arm
from gpmp2_tpu_torch.testing import dh_chain, random_system


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,n,m,scaling", [
    (torch.float32, 2048, 11, 14, True), (torch.float32, 37, 5, 6, True),
    (torch.float32, 100, 7, 4, False), (torch.float64, 64, 11, 14, True),
    (torch.float64, 9, 3, 34, True)])
def test_btsolve_kernel_matches_plain(cuda_device, dtype, B, n, m, scaling):
    D, U, b, lam = (torch.as_tensor(a, dtype=dtype, device=cuda_device)
                    for a in random_system(B, n, m, seed=11))
    x = block_tridiag_solve_cuda(D, U, b, scaling, lam)
    x_ref = block_tridiag_solve_torch(D.double(), U.double(), b.double(),
                                      scaling, lam.double())
    # float32: relative to the solution's scale (random systems with
    # condition ~1e2 after scaling); float64: same recurrences, reassociated
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((x.double() - x_ref).abs().max()) <= tol * float(x_ref.abs().max())


def _check_btsolve(device, dtype, B, n, m, damped=True, scaling=True, seed=5):
    D, U, b, lam = (torch.as_tensor(a, dtype=dtype, device=device)
                    for a in random_system(B, n, m, seed, damped, conditioned=True))
    x = block_tridiag_solve_cuda(D, U, b, scaling, lam)
    x_ref = block_tridiag_solve_torch(D.double(), U.double(), b.double(),
                                      scaling, lam.double())
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert x.shape == (B, n, m)
    assert float((x.double() - x_ref).abs().max()) <= tol * float(x_ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m", [(torch.float32, m) for m in range(2, 37, 2)]
                         + [(torch.float64, m) for m in (4, 6, 14, 34, 36)])
def test_btsolve_kernel_every_block_size(cuda_device, dtype, m):
    _check_btsolve(cuda_device, dtype, 33, 11, m)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 11, 101])
@pytest.mark.parametrize("B", [1, 33, 2048])
def test_btsolve_kernel_batch_and_length(cuda_device, B, n):
    _check_btsolve(cuda_device, torch.float32, B, n, 14)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("damped,scaling", [(False, True), (True, False), (False, False)])
def test_btsolve_kernel_gn_and_unscaled(cuda_device, dtype, damped, scaling):
    """lambda = 0 (the GN path) and Jacobi scaling off."""
    _check_btsolve(cuda_device, dtype, 65, 11, 14, damped, scaling)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,m", [(torch.float32, 14), (torch.float64, 34)])
def test_btsolve_kernel_indefinite_lane(cuda_device, dtype, m):
    """An indefinite block on one lane makes that lane's x non-finite and
    leaves every other lane as the plain version has it."""
    B, n, bad = 33, 11, 7
    D, U, b, lam = random_system(B, n, m, seed=9, conditioned=True)
    # a 2 x 2 minor with off-diagonal 3 sqrt(d0 d1): a negative pivot even
    # after damping and scaling
    d0, d1 = D[bad, 5, 0, 0] + lam[bad], D[bad, 5, 1, 1] + lam[bad]
    D[bad, 5, 0, 1] = D[bad, 5, 1, 0] = 3 * np.sqrt(d0 * d1)
    D, U, b, lam = (torch.as_tensor(a, dtype=dtype, device=cuda_device)
                    for a in (D, U, b, lam))
    x = block_tridiag_solve_cuda(D, U, b, True, lam)
    x_ref = block_tridiag_solve_torch(D.double(), U.double(), b.double(), True,
                                      lam.double())
    assert not bool(torch.isfinite(x[bad]).any())
    assert not bool(torch.isfinite(x_ref[bad]).any())
    good = torch.arange(B, device=cuda_device) != bad
    xg, rg = x[good].double(), x_ref[good]
    assert bool(torch.isfinite(xg).all())
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((xg - rg).abs().max()) <= tol * float(rg.abs().max())


@pytest.mark.cuda
def test_btsolve_kernel_rejects_odd_block(cuda_device):
    D, U, b, lam = (torch.as_tensor(a, device=cuda_device)
                    for a in random_system(4, 3, 5, seed=1))
    with pytest.raises(ValueError):
        block_tridiag_solve_cuda(D, U, b, True, lam)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_btsolve_launch_plan_fits(cuda_device, dtype):
    """Every block size the kernel takes, up to the PR2's m = 36, gets a
    block within the card's limits (1024 threads, 227 KB of shared
    memory); others are refused. At m = 36 in float64 one warp needs
    54,720 B, past the 48 KB default: the launch opts in."""
    for m in range(2, 37, 2):
        threads, smem = bt_launch_plan(m, dtype)
        assert threads % 32 == 0 and 32 <= threads <= 1024
        assert 0 < smem <= 232448
    assert bt_launch_plan(36, dtype) == ((32, 54720) if dtype == torch.float64
                                         else (32, 27360))
    for m in (0, 3, 38):
        with pytest.raises(ValueError):
            bt_launch_plan(m, dtype)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S", [1, 13, 16])
@pytest.mark.parametrize("d", [1, 3, 7, 16])
@pytest.mark.parametrize("N", ["1", "P-1", "P+1", "206848"])
def test_fk_arm_kernel_chain_shapes(cuda_device, N, d, S, dtype):
    """Tile edges (one configuration, one short of a tile, one over) and
    the main-path count, over dof, sphere count and dtype; the plain
    version runs in float64 on the same rounded operands."""
    P = fk_launch_plan(d, S, dtype)[0]
    N = {"1": 1, "P-1": P - 1, "P+1": P + 1, "206848": 206848}[N]
    consts, base, scent, link_ids = dh_chain(d, S, seed=d * 100 + S)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda_device)  # noqa: E731
    ops = (f(consts), f(base), f(scent),
           torch.as_tensor(link_ids, dtype=torch.int32, device=cuda_device))
    q = f(np.random.default_rng(N).uniform(-2, 2, (N, d)))
    c, J = arm_fk_spheres_cuda(*ops, q)
    c_ref, J_ref = fk_spheres_torch(*(t.double() if t.is_floating_point() else t
                                      for t in ops), q.double())
    assert c.shape == (N, S, 3) and J.shape == (N, S, 3, d)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((c.double() - c_ref).abs().max()) <= tol
    assert float((J.double() - J_ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fk_arm_launch_plan_fits(cuda_device, dtype):
    """Every (d, S) the kernel takes gets a tile of whole 16-byte vectors
    within the card's limits; a sphere table too large for one tile, and a
    dof above 16, are refused by the plan and by the wrapper."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    for d in range(1, 17):
        for S in (0, 1, 13, 16, 64, 256, 1024):
            P, threads, smem = fk_launch_plan(d, S, dtype)
            assert P >= vec and P % vec == 0
            assert 32 <= threads <= 1024 and 0 < smem <= 232448
    with pytest.raises(ValueError):
        fk_launch_plan(17, 16, dtype)
    S = 20000
    with pytest.raises(ValueError):
        fk_launch_plan(7, S, dtype)
    consts, base, scent, link_ids = dh_chain(7, S, seed=1)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda_device)  # noqa: E731
    with pytest.raises(ValueError):
        arm_fk_spheres_cuda(f(consts), f(base), f(scent),
                            torch.as_tensor(link_ids, dtype=torch.int32,
                                            device=cuda_device), f(np.zeros((4, 7))))


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
    _hold_lookup(got, ref, dtype)


def _hold_lookup(got, ref, dtype, nan_first=True):
    """K3's outputs against its plain version's on the same inputs: the
    same arithmetic in the same dtype, only FMA contraction differs, so a
    few ulps of the field's scale; the masks equal, and (with `nan_first`)
    the NaN x coordinate of query 0 reaches dist (and the gradients that
    read fx)."""
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert torch.equal(got[-1], ref[-1])
    if nan_first:
        assert torch.isnan(got[0][0]) and torch.isnan(ref[0][0])
    for g, r in zip(got[:-1], ref[:-1]):
        fin = ~torch.isnan(r)
        assert torch.equal(~torch.isnan(g), fin)
        scale = float(r[fin].abs().max())
        assert float((g[fin] - r[fin]).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("narrow", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sdf_lookup_kernel_narrow_rows(cuda_device, narrow, dtype):
    """Packed 3D rows in float16 / bfloat16 under float32 and float64 queries."""
    from gpmp2_tpu_torch.obstacle.sdf import pack_sdf
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda, sdf_lookup_torch

    sdf, pts = _lookup_case(3, 0, 5000, dtype, cuda_device)
    table = pack_sdf(dataclasses.replace(sdf, packed=None), narrow).packed
    args = (table, sdf.origin, sdf.cell_size, sdf.grid)
    _hold_lookup(sdf_lookup_cuda(pts, *args), sdf_lookup_torch(pts, *args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("worlds", [0, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sdf_lookup_kernel_corner_major(cuda_device, worlds, dtype):
    """The corner-major planar table, one shared world or one per problem,
    against the plain version and the row-major kernel."""
    from gpmp2_tpu_torch.obstacle.sdf import pack_planar_sdf
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda, sdf_lookup_torch

    sdf, pts = _lookup_case(2, worlds, 5000, dtype, cuda_device)
    cm = pack_planar_sdf(dataclasses.replace(sdf, packed=None), corner_major=True)
    table = cm.packed.reshape(-1, 4, cm.cells)
    args = (table, sdf.origin, sdf.cell_size, sdf.grid, 5000 if worlds else 0)
    got = sdf_lookup_cuda(pts, *args, corner_major=True)
    _hold_lookup(got, sdf_lookup_torch(pts, *args, corner_major=True), dtype)
    # the same corners through the same arithmetic as the row-major kernel
    rows = sdf_lookup_cuda(pts, sdf.packed.reshape(-1, 4), *args[1:])
    assert torch.equal(got[-1], rows[-1])
    for g, r in zip(got[:-1], rows[:-1]):
        assert torch.equal(g.isnan(), r.isnan()) and torch.equal(g.nan_to_num(), r.nan_to_num())


def _planar_case(worlds, N, dtype, device, grid=(40, 50), seed=4):
    """Points over a planar grid (cell 0.05) and a margin outside it, the
    first queries (where N > 1) NaN in x, NaN in y, +inf, -inf, far outside
    and on the top face, and random tables of either layout that no
    packing built: rows (W * cells, 4) and corner-major (W, 4, cells)."""
    rng = np.random.default_rng(seed + N + worlds)
    cells = grid[0] * grid[1]
    W = max(worlds, 1)
    origin, cell = np.array([-0.5, -1.0]), 0.05
    ext = np.array(grid[::-1]) * cell
    pts = origin + rng.uniform(-0.1, 1.1, size=(N, 2)) * ext
    top = origin + (np.array(grid[::-1]) - 1) * cell
    special = [[np.nan, 0.0], [0.0, np.nan], [np.inf, 0.0], [0.0, -np.inf], [1e6, -1e6],
               list(top)]
    if N > 1:
        pts[:min(N, len(special))] = special[:N]
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    return (f(pts), f(rng.normal(size=(W * cells, 4))), f(rng.normal(size=(W, 4, cells))),
            f(origin), f(cell), grid)


def _force_route(monkeypatch, route):
    """Make the wrapper take `route` for every corner-major table."""
    from gpmp2_tpu_torch.ops import sdf_lookup

    monkeypatch.setattr(sdf_lookup, "corner_major_route", lambda *a: route)


def _equal_bits(a, b):
    assert torch.equal(a[-1], b[-1])
    for g, r in zip(a[:-1], b[:-1]):
        assert torch.equal(g.isnan(), r.isnan()) and torch.equal(g.nan_to_num(), r.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["row_major", "direct", "interleaved"])
@pytest.mark.parametrize("worlds", [0, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("per_world", [1, 259, 350_003])
def test_sdf_planar_kernel_routes(cuda_device, monkeypatch, route, worlds, dtype, per_world):
    """The planar kernel on random tables of both layouts, one shared world
    or one per problem (3 worlds), each corner-major route forced: against
    the plain version at N = 1 (one world), N not a multiple of any tile
    and N over a million (above one wave of blocks), NaN, infinite and
    far-off points among the queries (N > 1); the two corner-major routes
    bit-equal."""
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda, sdf_lookup_torch

    N = per_world * max(worlds, 1)
    pts, rows, cm, origin, cell, grid = _planar_case(worlds, N, dtype, cuda_device)
    qpw = per_world if worlds else 0
    if route == "row_major":
        table, kw = rows, {}
    else:
        _force_route(monkeypatch, route)
        table, kw = cm, {"corner_major": True}
    got = sdf_lookup_cuda(pts, table, origin, cell, grid, qpw, **kw)
    _hold_lookup(got, sdf_lookup_torch(pts, table, origin, cell, grid, qpw, **kw), dtype,
                 nan_first=N > 1)
    if route != "row_major":
        _force_route(monkeypatch, "direct" if route == "interleaved" else "interleaved")
        _equal_bits(got, sdf_lookup_cuda(pts, table, origin, cell, grid, qpw, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("worlds", [0, 2])
def test_sdf_planar_route_threshold(cuda_device, monkeypatch, dtype, worlds):
    """The chooser's threshold (8 * itemsize * W * cells + LAUNCH_BYTES <=
    96 * N): the last N below it reads the corner-major table directly, the
    first N at it interleaves, each against the plain version and
    bit-equal to the other route; the points (N, 3) as K2's centres are,
    strided."""
    from gpmp2_tpu_torch.ops import sdf_lookup

    W = max(worlds, 1)
    cells = 40 * 50
    itemsize = torch.empty((), dtype=dtype).element_size()
    # the least N that interleaves
    first = -(-(8 * itemsize * W * cells + sdf_lookup.LAUNCH_BYTES) // 96)
    if worlds:
        first = -(-first // W) * W
    taken = []
    chooser = sdf_lookup.corner_major_route

    def spy(*args):
        taken.append(chooser(*args))
        return taken[-1]
    for N, want in ((first - W, "direct"), (first, "interleaved")):
        pts, _, cm, origin, cell, grid = _planar_case(worlds, N, dtype, cuda_device)
        pts = torch.cat([pts, torch.zeros_like(pts[:, :1])], 1)
        qpw = N // W if worlds else 0
        monkeypatch.setattr(sdf_lookup, "corner_major_route", spy)
        got = sdf_lookup.sdf_lookup_cuda(pts, cm, origin, cell, grid, qpw, corner_major=True)
        assert taken[-1] == want
        _hold_lookup(got, sdf_lookup.sdf_lookup_torch(pts, cm, origin, cell, grid, qpw,
                                                      corner_major=True), dtype)
        _force_route(monkeypatch, "interleaved" if want == "direct" else "direct")
        _equal_bits(got, sdf_lookup.sdf_lookup_cuda(pts, cm, origin, cell, grid, qpw,
                                                    corner_major=True))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["row_major", "direct", "interleaved"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sdf_planar_kernel_2x2_world(cuda_device, monkeypatch, route, dtype):
    """The 2 x 2 world (one cell, four corners; its corner-major table is
    (4, 4)) on every route, 100 points over and around it."""
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda, sdf_lookup_torch

    pts, rows, cm, origin, cell, grid = _planar_case(0, 100, dtype, cuda_device, grid=(2, 2))
    if route == "row_major":
        table, kw = rows, {}
    else:
        _force_route(monkeypatch, route)
        table, kw = cm, {"corner_major": True}
    got = sdf_lookup_cuda(pts, table, origin, cell, grid, **kw)
    _hold_lookup(got, sdf_lookup_torch(pts, table, origin, cell, grid, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("screen", ["hull", "coarse"])
@pytest.mark.parametrize("table", ["packed", "raw", "float16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S", [1, 4])
def test_sdf_lookup_kernel_screens(cuda_device, screen, table, dtype, S):
    """The hull and coarse screens on each 3D table form, with one
    threshold or one per sphere (query i reads thresh[i % S]); the kernel
    screens exactly the plain version's queries."""
    from gpmp2_tpu_torch.obstacle.sdf import pack_sdf, screen_sdf
    from gpmp2_tpu_torch.ops.sdf_lookup import screen_bound, sdf_lookup_cuda, sdf_lookup_torch

    sdf, pts = _lookup_case(3, 0, 5000, dtype, cuda_device)
    raw = dataclasses.replace(sdf, packed=None)
    rng = np.random.default_rng(8)
    # thresholds within each bound's range: the hull distances of random
    # boxes, the min-pooled values of the normal field
    if screen == "hull":
        lo = rng.uniform([-0.5, -1.0, 0.25], [1.5, 0.5, 1.25], (12, 3))
        boxes = np.stack([lo, lo + rng.uniform(0.0, 0.3, (12, 3))], axis=1)
        kw, span = {"boxes": torch.as_tensor(boxes, dtype=dtype, device=cuda_device)}, (-0.5, 1.0)
    else:
        s = screen_sdf(raw, 4)
        kw, span = {"coarse": s.coarse, "coarse_cell": s.coarse_cell}, (-3.0, -2.0)
    kw["thresh"] = torch.as_tensor(rng.uniform(*span, S), dtype=dtype, device=cuda_device)
    t = {"packed": sdf.packed.reshape(-1, 8), "raw": sdf.data.reshape(-1),
         "float16": pack_sdf(raw, torch.float16).packed}[table]
    args = (t, sdf.origin, sdf.cell_size, sdf.grid)
    got = sdf_lookup_cuda(pts, *args, **kw)
    _hold_lookup(got, sdf_lookup_torch(pts, *args, **kw), dtype)
    _, screened = screen_bound(pts, sdf.origin, sdf.cell_size, **kw)
    assert 0 < int(screened.sum()) < pts.shape[0]
    assert not bool(torch.cat([g[screened] for g in got[1:-1]]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["screen_with_worlds", "narrow_planar", "no_boxes",
                                 "thresh_not_dividing", "screen_without_thresh"])
def test_sdf_lookup_kernel_rejects_bad_variants(cuda_device, bad):
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda

    dim = 2 if bad == "narrow_planar" else 3
    sdf, pts = _lookup_case(dim, 16 if bad == "screen_with_worlds" else 0, 100,
                            torch.float32, cuda_device)
    table = sdf.packed.reshape(-1, 2 ** dim)
    boxes = torch.zeros(1, 2, 3, device=cuda_device)
    thresh = torch.zeros(1, device=cuda_device)
    kw, qpw = {"thresh": thresh, "boxes": boxes}, 0
    if bad == "screen_with_worlds":
        qpw = 100
    elif bad == "narrow_planar":
        table, kw = table.half(), {}
    elif bad == "no_boxes":
        kw["boxes"] = boxes[:0]
    elif bad == "thresh_not_dividing":
        kw["thresh"] = torch.zeros(3, device=cuda_device)
    else:
        del kw["thresh"]
    with pytest.raises(ValueError):
        sdf_lookup_cuda(pts, table, sdf.origin, sdf.cell_size, sdf.grid, qpw, **kw)


@pytest.mark.cuda
def test_sdf_lookup_kernel_rejects_misaligned_table(cuda_device):
    from gpmp2_tpu_torch.ops.sdf_lookup import sdf_lookup_cuda

    sdf, pts = _lookup_case(3, 0, 100, torch.float32, cuda_device)
    buf = torch.empty(sdf.packed.numel() + 1, dtype=torch.float32, device=cuda_device)
    rows = buf[1:].view(-1, 8)
    rows.copy_(sdf.packed)
    with pytest.raises(ValueError, match="16-byte"):
        sdf_lookup_cuda(pts, rows, sdf.origin, sdf.cell_size, sdf.grid)


# the persistent screen kernel's cases: (screen, table, dtype, N, S, boxes
# or coarse factor, thresholds). N below one block, N = 7 * 150,001 (no
# multiple of any persistent grid's threads), the main path's 3,309,568;
# S 1, 7 and 16 dividing N; 1, 12 and 1024 boxes (1024 float64 boxes fill
# the 48 KB of shared memory); thresholds that screen some, every or no
# query; coarse tables of the (60, 70, 80) field at factor 2 (168 KB in
# float32, 336 KB in float64) and 1 (1.3 MB in float32)
SCREEN_CASES = [
    ("hull", "packed", torch.float32, 100, 1, 12, "some"),
    ("hull", "packed", torch.float32, 1_050_007, 7, 12, "some"),
    ("hull", "packed", torch.float32, 3_309_568, 16, 12, "some"),
    ("hull", "raw", torch.float64, 7_000, 7, 1, "some"),
    ("hull", "packed", torch.float32, 16_000, 16, 1024, "some"),
    ("hull", "raw", torch.float64, 16_000, 16, 1024, "some"),
    ("hull", "packed", torch.float32, 7_000, 7, 12, "all"),
    ("hull", "packed", torch.float32, 7_000, 7, 12, "none"),
    ("coarse", "packed", torch.float32, 100, 1, 2, "some"),
    ("coarse", "packed", torch.float32, 1_050_007, 7, 2, "some"),
    ("coarse", "packed", torch.float32, 3_309_568, 16, 2, "some"),
    ("coarse", "raw", torch.float64, 7_000, 7, 2, "some"),
    ("coarse", "packed", torch.float64, 1_050_007, 7, 2, "some"),
    ("coarse", "packed", torch.float32, 16_000, 16, 1, "some"),
    ("coarse", "raw", torch.float32, 7_000, 7, 2, "all"),
    ("coarse", "raw", torch.float64, 7_000, 7, 2, "none"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("screen,table,dtype,N,S,size,which", SCREEN_CASES)
def test_sdf_screen_kernel_cases(cuda_device, screen, table, dtype, N, S, size, which):
    """The persistent screen kernel against `screen_bound` and
    `sdf_lookup_torch`: a query that `screen_bound` screens carries exactly
    its bound and a zero gradient, every output lies within `_hold_lookup`'s
    tolerance of the plain version's (NaN where it is NaN; an unscreened
    query's interpolated distance is far from its bound, so a query screened
    differently fails here), and the in-range masks are equal. The points
    cover the grid and a margin outside it, with query 0's x NaN."""
    from gpmp2_tpu_torch.obstacle.sdf import SignedDistanceField, pack_sdf, screen_sdf
    from gpmp2_tpu_torch.ops.sdf_lookup import screen_bound, sdf_lookup_cuda, sdf_lookup_torch

    rng = np.random.default_rng(N + S + size)
    grid, cell = (60, 70, 80), 0.05
    origin = np.array([-0.5, -1.0, 0.25])
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=cuda_device)  # noqa: E731
    raw = SignedDistanceField(f(origin), f(cell), f(rng.normal(size=grid)))
    ext = np.array(grid[::-1]) * cell
    pts = origin + rng.uniform(-0.1, 1.1, size=(N, 3)) * ext
    pts[0, 0] = np.nan
    pts = f(pts)
    if screen == "hull":
        # boxes inside the grid's span, or (every query screened) beyond it
        far = 100.0 if which == "all" else 0.0
        lo = origin + far + rng.uniform(0.0, 1.0, (size, 3)) * ext
        boxes = np.stack([lo, lo + rng.uniform(0.0, 0.3, (size, 3))], axis=1)
        kw, span = {"boxes": f(boxes)}, (-0.3, 0.3)
    else:
        s = screen_sdf(raw, size)
        kw, span = {"coarse": s.coarse, "coarse_cell": s.coarse_cell}, (-2.5, -1.5)
    if which == "some":
        kw["thresh"] = f(rng.uniform(*span, S))
    else:
        kw["thresh"] = f(np.full(S, -1e9 if which == "all" else 1e9))
    t = pack_sdf(raw).packed.reshape(-1, 8) if table == "packed" else raw.data.reshape(-1)
    args = (t, raw.origin, raw.cell_size, raw.grid)
    got = sdf_lookup_cuda(pts, *args, **kw)
    ref = sdf_lookup_torch(pts, *args, **kw)
    torch.cuda.synchronize()
    bound, screened = screen_bound(pts, raw.origin, raw.cell_size, **kw)
    # the NaN point's hull bound is NaN, which screens it under any threshold
    finite = ~pts.isnan().any(1)
    n, nf = int(screened[finite].sum()), int(finite.sum())
    assert {"some": 0 < n < nf, "all": n == nf, "none": n == 0}[which]
    assert torch.equal(got[0][screened].nan_to_num(), bound[screened].nan_to_num())
    assert not bool(torch.cat([g[screened] for g in got[1:-1]]).any())
    # query 0's dist need not be NaN: the coarse screen gives it a table value
    _hold_lookup(got, ref, dtype, nan_first=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_btsolve_kernel_mobile_gauss_newton(cuda_device, dtype):
    """K1 at the MobileBaseSE2 shape (m = 6, n = 16, B = 4096) with
    lambda = 0, as Dogleg's Gauss-Newton point solves it."""
    _check_btsolve(cuda_device, dtype, 4096, 16, 6, damped=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("damped", [True, False])
def test_btsolve_kernel_pr2_block(cuda_device, dtype, damped):
    """K1 at the PR2's shape (m = 36, n = 11, B = 2048), damped and with
    lambda = 0."""
    _check_btsolve(cuda_device, dtype, 2048, 11, 36, damped=damped)


@pytest.mark.cuda
def test_btsolve_kernel_rejects_block_over_36(cuda_device):
    D, U, b, lam = (torch.as_tensor(a, device=cuda_device)
                    for a in random_system(2, 3, 38, seed=1))
    with pytest.raises(ValueError, match="36"):
        block_tridiag_solve_cuda(D, U, b, True, lam)


@pytest.mark.cuda
def test_pr2_linearize_card_matches_cpu(cuda_device):
    """One PR2 linearize (SE(2) x R^15 states, 65 spheres on a 3D field,
    the self-collision pairs, a workspace pose slot, vehicle dynamics, one
    interpolated state per interval) on the card (K3 and the torch.func
    Jacobians) against the CPU's plain path, float64, rtol 1e-9."""
    from gpmp2_tpu_torch.planner import (Trajectory, TrajOptimizerSetting,
                                         init_traj_straight_line, make_problem,
                                         set_workspace_prior, traj_linearize)
    from gpmp2_tpu_torch.robots import generate_mobile_arm
    from gpmp2_tpu_torch.utils import convert

    n, cell, origin = 40, 0.1, np.array([-2.0, -2.0, -0.5])
    Z, Y, X = np.meshgrid(*(origin[k] + cell * np.arange(n) for k in (2, 1, 0)),
                          indexing="ij")
    data = np.sqrt((X + 0.2) ** 2 + Y ** 2 + (Z - 1.0) ** 2) - 0.3
    setting = TrajOptimizerSetting(dof=18, total_step=4, total_time=4.0, cost_sigma=0.05,
                                   epsilon=0.1, obs_check_inter=1, opt_type="lm")
    rng = np.random.default_rng(3)
    B = 16
    s = np.concatenate([rng.uniform(-1.0, -0.6, (B, 2)), 0.3 * rng.normal(size=(B, 16))], 1)
    g = s + 0.3 * rng.normal(size=(B, 18))
    s[:, 4], s[:, 11] = -0.2, 0.2  # the forearms meet: active pairs
    noise = rng.normal(size=(2, B, 5, 18))
    pairs = [(a, b, 0.02, 0.05) for a in range(24, 42) for b in range(47, 65)]
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        f = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        z = torch.zeros(B, 18, dtype=torch.float64, device=dev)
        probs = make_problem(generate_mobile_arm("PR2", dtype=torch.float64, device=dev),
                             convert.sdf_from_numpy(origin, cell, data, dtype=torch.float64,
                                                    device=dev),
                             f(s), z, f(g), z, setting, self_collision_pairs=pairs, num_ws=1,
                             flag_vehicle_dynamics=True, dyn_sigma=0.01)
        probs = set_workspace_prior(probs, 0, 2, 8, point=[0.3, 0.2, 1.1], rot=np.eye(3))
        line = init_traj_straight_line(probs.space, f(s), f(g), 4, 4.0)
        traj = Trajectory(line.pose + 0.1 * f(noise[0]), line.vel + 0.1 * f(noise[1]))
        out.append([t.cpu() for t in traj_linearize(probs, traj)])
    for name, a, b in zip(("H_diag", "H_off", "b", "err"), *out):
        assert torch.allclose(a, b, rtol=1e-9, atol=1e-12 * float(b.abs().max())), name


@pytest.mark.cuda
def test_mobile_base_linearize_card_matches_cpu(cuda_device):
    """One MobileBaseSE2 linearize (SE(2) states, Lie GP prior, vehicle
    dynamics, interpolated obstacle factors on the MobileMap1 field) on the
    card (K3 and the torch.func Jacobians) against the CPU's plain path,
    float64, rtol 1e-9."""
    from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy
    from gpmp2_tpu_torch.planner import (Trajectory, TrajOptimizerSetting,
                                         init_traj_straight_line, make_problem,
                                         traj_linearize)
    from gpmp2_tpu_torch.robots import generate_mobile_base

    ds = generate_2d_dataset("MobileMap1")
    setting = TrajOptimizerSetting(dof=3, total_step=15, total_time=15.0, cost_sigma=0.01,
                                   obs_check_inter=3, opt_type="lm", Qc=np.eye(3))
    rng = np.random.default_rng(2)
    B = 64
    s = np.stack([rng.uniform(-3.5, -2.5, B), rng.uniform(-3.5, -2.5, B),
                  rng.uniform(-0.5, 0.5, B)], -1)
    g = np.stack([rng.uniform(2.5, 3.5, B), rng.uniform(2.5, 3.5, B),
                  rng.uniform(1.0, 2.0, B)], -1)
    noise = rng.normal(size=(2, B, 16, 3))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=torch.float64,
                                        device=dev)
        f = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        z = torch.zeros(B, 3, dtype=torch.float64, device=dev)
        probs = make_problem(generate_mobile_base(dtype=torch.float64, device=dev), sdf,
                             f(s), z, f(g), z, setting, flag_vehicle_dynamics=True,
                             dyn_sigma=0.001)
        line = init_traj_straight_line(probs.space, f(s), f(g), 15, 15.0)
        traj = Trajectory(line.pose + 0.2 * f(noise[0]), line.vel + 0.2 * f(noise[1]))
        out.append([t.cpu() for t in traj_linearize(probs, traj)])
    for name, a, b in zip(("H_diag", "H_off", "b", "err"), *out):
        assert torch.allclose(a, b, rtol=1e-9, atol=1e-12 * float(b.abs().max())), name


def _graph_launches():
    from gpmp2_tpu_torch.utils import trace

    c = trace.counters()
    return c["launches.k1"], c["launches.k2"], c["launches.k3"]


def _ball_field(dev, dtype):
    """A 40^3 field (cell 0.1 m) of one ball in the WAM's workspace."""
    from gpmp2_tpu_torch.utils import convert

    n, cell, origin = 40, 0.1, np.array([-2.013, -2.021, -1.007])
    Z, Y, X = np.meshgrid(*(origin[k] + cell * np.arange(n) for k in (2, 1, 0)),
                          indexing="ij")
    data = np.sqrt((X - 0.3) ** 2 + (Y + 0.2) ** 2 + (Z - 0.4) ** 2) - 0.3
    return convert.sdf_from_numpy(origin, cell, data, dtype=dtype, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_factor_graph_card_matches_cpu(cuda_device, dtype):
    """A WAM FactorGraph (4 states, 2 interpolated factors per interval) on
    a small 3D field: error and linearize on the card against the CPU's
    plain path (float64: rtol 1e-9; float32: 1e-4 of each array's scale,
    the error 1e-5),
    each obstacle group launching K2 and K3 once per linearize, never the
    plain versions; optimize ends with equal iterations."""
    from gpmp2_tpu_torch.planner import FactorGraph, Trajectory, init_traj_straight_line
    from gpmp2_tpu_torch.robots import generate_arm
    from gpmp2_tpu_torch.solver.optimize import OptimizerParams

    start = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
    goal = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
    noise = np.random.default_rng(5).normal(size=(2, 4, 7))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
        robot, sdf = generate_arm("WAMArm", dtype=dtype, device=dev), _ball_field(dev, dtype)
        g = FactorGraph(robot.space, 4)
        g.add_prior_pose(0, f(start), 1e-3).add_prior_vel(0, f(np.zeros(7)), 1e-3)
        g.add_prior_pose(3, f(goal), 1e-3).add_prior_vel(3, f(np.zeros(7)), 1e-3)
        for i in range(4):
            g.add_obstacle(i, robot, sdf, 0.05, 0.2)
        for i in range(3):
            g.add_gp_prior(i, i + 1, 0.5, np.eye(7))
            for tau in (0.15, 0.3):
                g.add_obstacle_gp(i, i + 1, robot, sdf, 0.05, 0.2, np.eye(7), 0.5, tau)
        line = init_traj_straight_line(robot.space, f(start), f(goal), 3, 1.5)
        traj = Trajectory(line.pose + 0.1 * f(noise[0]), line.vel + 0.1 * f(noise[1]))
        before = _graph_launches()
        lin = [t.cpu() for t in g.linearize(traj)]
        after = _graph_launches()
        res = g.optimize(line, OptimizerParams(method="lm", max_iter=30, rel_thresh=1e-4))
        out.append((lin, float(g.error(traj)), int(res.iterations), before, after))
    (lin_c, err_c, it_c, before, after), (lin_p, err_p, it_p, *_) = out
    assert after[1] - before[1] == 2 and after[2] - before[2] == 2  # K2, K3: two groups
    tol = 1e-9 if dtype == torch.float64 else 1e-5
    assert abs(err_c - err_p) <= tol * err_p
    for name, a, b in zip(("H_diag", "H_off", "b", "err"), lin_c, lin_p):
        if dtype == torch.float64:
            assert torch.allclose(a, b, rtol=1e-9, atol=1e-12 * float(b.abs().max())), name
        else:
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name
    if dtype == torch.float64:
        assert it_c == it_p


@pytest.mark.cuda
def test_mobile_factor_graph_card_matches_cpu(cuda_device):
    """An SE(2) x R^2 FactorGraph (vehicle dynamics, joint limits, the Lie
    interpolation of two factors per interval) beside a disc, float64: the
    card's linearize (K3, no K2: the mobile FK is plain torch) against the
    CPU's at rtol 1e-9."""
    from gpmp2_tpu_torch.planner import FactorGraph, Trajectory, init_traj_straight_line
    from gpmp2_tpu_torch.robots import generate_mobile_arm
    from gpmp2_tpu_torch.utils import convert

    n, cell, origin = 120, 0.05, np.array([-3.013, -3.021])
    X, Y = np.meshgrid(origin[0] + cell * np.arange(n), origin[1] + cell * np.arange(n))
    data = np.sqrt((X - 0.5) ** 2 + (Y - 0.2) ** 2) - 0.4
    start = np.array([-0.6, -0.3, 0.2, 0.1, -0.3])
    goal = np.array([0.9, 0.5, 0.6, 0.4, 0.2])
    noise = np.random.default_rng(6).normal(size=(2, 4, 5))
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        f = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        robot = generate_mobile_arm("SimpleTwoLinksArm", dtype=torch.float64, device=dev)
        sdf = convert.planar_sdf_from_numpy(origin, cell, data, dtype=torch.float64, device=dev)
        g = FactorGraph(robot.space, 4)
        g.add_prior_pose(0, f(start), 1e-2).add_prior_pose(3, f(goal), 1e-2)
        for i in range(4):
            g.add_obstacle(i, robot, sdf, 0.1, 0.2).add_vehicle_dynamics(i, 0.05)
            g.add_joint_limit(i, -0.2 * np.ones(5), 0.3 * np.ones(5), 1e-3, 0.01)
        for i in range(3):
            g.add_gp_prior(i, i + 1, 1.0, np.eye(5))
            for tau in (0.3, 0.6):
                g.add_obstacle_gp(i, i + 1, robot, sdf, 0.1, 0.2, np.eye(5), 1.0, tau)
        line = init_traj_straight_line(robot.space, f(start), f(goal), 3, 3.0)
        traj = Trajectory(line.pose + 0.15 * f(noise[0]), line.vel + 0.15 * f(noise[1]))
        before = _graph_launches()
        out.append(([t.cpu() for t in g.linearize(traj)], before, _graph_launches()))
    (lin_c, before, after), (lin_p, *_) = out
    assert after[1] == before[1] and after[2] - before[2] == 2
    for name, a, b in zip(("H_diag", "H_off", "b", "err"), lin_c, lin_p):
        assert torch.allclose(a, b, rtol=1e-9, atol=1e-12 * float(b.abs().max())), name


@pytest.mark.cuda
def test_multigraph_card_matches_cpu(cuda_device):
    """A small point-robot planner graph (3 chains of 6 steps, inter-chain
    edges) beside a disc, float64: the graph error, the dense whitened
    system (its obstacle rows through K3) and the LM result on the card
    against the CPU."""
    from gpmp2_tpu_torch.kinematics import PointRobotFK, make_robot_model
    from gpmp2_tpu_torch.planner import (build_planner_graph, make_multigraph_problem,
                                         multigraph_error, optimize_multigraph)
    from gpmp2_tpu_torch.planner.multigraph import _whitened_system
    from gpmp2_tpu_torch.utils import convert

    n, cell, origin = 80, 0.1, np.array([-1.013, -1.021])
    X, Y = np.meshgrid(origin[0] + cell * np.arange(n), origin[1] + cell * np.arange(n))
    data = np.sqrt((X - 3.0) ** 2 + (Y - 2.4) ** 2) - 1.0
    rng = np.random.default_rng(7)
    t = np.linspace(0.0, 1.0, 7)[:, None]
    chains = np.stack([t * [6.0, 5.0] + 0.6 * rng.normal(size=(7, 2)) * np.sin(np.pi * t)
                       for _ in range(3)])
    pose0, vel0, edges = build_planner_graph(chains, [1.0, 0.8], 0.5, 3)
    out = []
    for dev in (cuda_device, torch.device("cpu")):
        f = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        robot = make_robot_model(PointRobotFK(), [(0, 0.5, (0.0, 0.0, 0.0))],
                                 dtype=torch.float64, device=dev)
        sdf = convert.planar_sdf_from_numpy(origin, cell, data, dtype=torch.float64, device=dev)
        z = f(np.zeros(2))
        prob = make_multigraph_problem(robot, sdf, edges, z, z, f([6.0, 5.0]), z, dt=1.0,
                                       Qc=np.eye(2), cost_sigma=0.2, epsilon=0.5,
                                       obs_check_inter=2, dtype=torch.float64)
        P, V = f(pose0), f(vel0)
        before = _graph_launches()
        r, J = _whitened_system(prob, P, V)
        after = _graph_launches()
        res = optimize_multigraph(prob, P, V)
        out.append((float(multigraph_error(prob, P, V)), r.cpu(), J.cpu(), float(res[2]),
                    int(res[3]), after[2] - before[2]))
    card, plain = out
    assert card[5] == 2  # K3: the node and the interpolated obstacle rows
    assert abs(card[0] - plain[0]) <= 1e-9 * plain[0]
    for a, b in ((card[1], plain[1]), (card[2], plain[2])):
        assert torch.allclose(a, b, rtol=1e-9, atol=1e-12 * float(b.abs().max()))
    assert card[4] == plain[4] and abs(card[3] - plain[3]) <= 1e-6 * plain[3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,P", [(torch.float64, 257, 4), (torch.float32, 1025, 16)])
def test_partitioned_solve_on_card(cuda_device, dtype, n, P):
    """The Schur-partitioned solve on the card (its separator system through
    K1) against K1 alone on the same systems."""
    from gpmp2_tpu_torch.ops.btsolve import block_tridiag_solve_cuda
    from gpmp2_tpu_torch.solver import block_tridiag_solve_partitioned
    from gpmp2_tpu_torch.utils import trace

    D, U, b, _ = (torch.as_tensor(a, dtype=dtype, device=cuda_device)
                  for a in random_system(8, n, 14, seed=n, conditioned=True))
    launches = trace.counters()["launches.k1"]
    x = block_tridiag_solve_partitioned(D, U, b, P)
    assert trace.counters()["launches.k1"] == launches + 1
    x_ref = block_tridiag_solve_cuda(D, U, b)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((x - x_ref).abs().max()) <= tol * float(x_ref.abs().max())


@pytest.mark.cuda
def test_partitioned_odd_block_raises_on_card(cuda_device):
    """K1 takes even m only; the separator system does not detour to the
    plain version on a CUDA tensor."""
    from gpmp2_tpu_torch.solver import block_tridiag_solve_partitioned

    D, U, b, _ = (torch.as_tensor(a, device=cuda_device)
                  for a in random_system(1, 31, 3, seed=3))
    with pytest.raises(ValueError, match="must be even"):
        block_tridiag_solve_partitioned(D[0], U[0], b[0], 4)


@pytest.mark.cuda
def test_ts_sharded_one_rank_nccl(cuda_device):
    """The ts-sharded solve on a one-rank NCCL group against K1 alone."""
    import torch.distributed as dist

    from gpmp2_tpu_torch.ops.btsolve import block_tridiag_solve_cuda
    from gpmp2_tpu_torch.parallel import make_mesh
    from gpmp2_tpu_torch.solver.partitioned import batched_block_tridiag_solve_ts_sharded

    mesh = make_mesh(shape=(1, 1), axis_names=("dp", "ts"), device=cuda_device)
    try:
        D, U, b, _ = (torch.as_tensor(a, device=cuda_device)
                      for a in random_system(4, 127, 6, seed=9, conditioned=True))
        x = batched_block_tridiag_solve_ts_sharded(mesh, D, U, b, 8)
        x_ref = block_tridiag_solve_cuda(D, U, b)
        assert float((x - x_ref).abs().max()) <= 1e-10 * float(x_ref.abs().max())
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_plan_batch_spans_on_the_profiler_clock(cuda_device):
    """A WAM plan_batch (B = 256 on the ball field) under a profiler of
    device activity alone, as the benchmark's traced window runs it,
    records its spans (gpmp2_tpu_torch/utils/trace.py) with no other
    switch; every device operation that starts before a stop test ends
    before that test's span ends (launched before the test's one sync, it
    is what the sync waits for), which holds only where spans and device
    events share one clock; and its launches are counted: one K1 an
    attempt, one K2 and one K3 a linearize."""
    from torch.profiler import ProfilerActivity, profile

    from gpmp2_tpu_torch.planner import (TrajOptimizerSetting, init_traj_straight_line,
                                         make_problem, optimizer_params_from_setting,
                                         plan_batch)
    from gpmp2_tpu_torch.utils import trace

    f32, B = torch.float32, 256
    robot, sdf = generate_arm("WAMArm", dtype=f32, device=cuda_device), _ball_field(
        cuda_device, f32)
    start = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
    goal = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
    noise = 0.05 * np.random.default_rng(8).normal(size=(2, B, 7))
    f = lambda a: torch.as_tensor(a, dtype=f32, device=cuda_device)  # noqa: E731
    setting = TrajOptimizerSetting(dof=7, total_step=10, total_time=2.0, epsilon=0.2,
                                   cost_sigma=0.02, obs_check_inter=9, opt_type="lm",
                                   max_iter=50, rel_thresh=1e-2, Qc=np.eye(7))
    zero = torch.zeros((B, 7), dtype=f32, device=cuda_device)
    probs = make_problem(robot, sdf, f(start + noise[0]), zero, f(goal + noise[1]), zero,
                         setting)
    init = init_traj_straight_line(probs.space, probs.start_pose, probs.end_pose,
                                   setting.total_step, setting.total_time)
    params = optimizer_params_from_setting(setting)
    plan_batch(probs, init, params)
    torch.cuda.synchronize()
    trace.enable(None)
    trace.clear()
    before = _graph_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        plan_batch(probs, init, params)
        torch.cuda.synchronize()
    launched = [b - a for a, b in zip(before, _graph_launches())]
    spans = trace.spans()
    trace.clear()
    (root,) = [s for s in spans if s[0] == "plan_batch"]
    attempts = root[6]["attempts"]
    assert attempts > 0 and launched == [attempts, attempts + 1, attempts + 1]
    tests = sorted((s[1], s[2]) for s in spans if s[0] == "stop_test")
    assert len(tests) == attempts + 1
    ops = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
           if "CUDA" in str(e.device_type()) and root[1] <= e.start_ns() <= root[2]]
    checked = 0
    for a, b in ops:
        nxt = next((t for t in tests if t[0] >= a), None)
        if nxt is not None:
            assert b <= nxt[1], (a, b, nxt)
            checked += 1
    assert checked >= 0.9 * len(ops) > 0


def _block_ratio(got, want, rtol):
    """Each output of the assembly against its twin: the (m, m) blocks of
    H_diag and H_off, the m-vectors of b and each lane's err, every block's
    |difference| within rtol of its norm; returns the worst ratio."""
    worst = 0.0
    for name, a, w, k in zip(("H_diag", "H_off", "b", "err"), got, want, (2, 2, 1, 0)):
        diff = (a.double() - w.double())
        if k:
            dn, wn = diff.flatten(-k).norm(dim=-1), w.double().flatten(-k).norm(dim=-1)
        else:
            dn, wn = diff.abs(), w.double().abs()
        assert bool(torch.isfinite(a).all()), name
        assert bool((dn <= rtol * wn).all()), (name, float((dn / wn.clamp_min(1e-300)).max()))
        worst = max(worst, float((dn / wn.clamp_min(1e-300)).max()))
    return worst


def _assembly_operands(dev, dtype, B, n, d, S, T, planar, seed, kron=False):
    """Random operands of the assembly kernel: lane 0's spheres all
    inactive (beyond eps_total), lane 1's half out of range; every other
    sphere in range with dist about eps_total. With `kron` each C_t is
    [a0 I | a1 I | a2 I | a3 I], the form of Qc = c I."""
    rng = np.random.default_rng(seed)
    C, m = n + (n - 1) * T, 2 * d
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    eps = f(rng.uniform(0.1, 0.3, S))
    dist = f(rng.uniform(-0.2, 0.4, (B, C, S)))
    dist[0] = 1.0
    ok = torch.ones((B, C, S), dtype=torch.bool, device=dev)
    if B > 1:
        ok[1, :, ::2] = False
    A = rng.normal(size=(m, m))
    coeff = (np.einsum("tk,jl->tjkl", rng.normal(size=(T, 4)), np.eye(d)).reshape(T, d, 4 * d)
             if kron else rng.normal(size=(T, d, 2 * m)))
    coeff = f(coeff)
    J1 = np.eye(m)
    J1[:d, d:] = 0.2 * np.eye(d)
    return (f(rng.normal(size=(B, n, d))), f(rng.normal(size=(B, n, d))),
            f(rng.normal(size=(B, C, S, 3, d))), dist, f(rng.normal(size=(B, C, S))),
            f(rng.normal(size=(B, C, S))), None if planar else f(rng.normal(size=(B, C, S))),
            ok, eps, f(400.0), coeff, f(J1), f(-np.eye(m)), f(A @ A.T + m * np.eye(m)),
            f(rng.normal(size=(B, d))), f(rng.normal(size=(B, d))), f(rng.uniform(1, 9, d)),
            f(rng.uniform(1, 9, d)), f(rng.normal(size=(B, d))), f(rng.normal(size=(B, d))),
            f(rng.uniform(1, 9, (B, d))), f(rng.uniform(1, 9, (B, d))))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d,S,T,n,B,planar,goal_prior,kron", [
    (7, 16, 9, 11, 33, False, True, False),   # the WAM's shapes
    (7, 16, 9, 11, 33, False, True, True),    # ... with Qc = c I's coefficients
    (1, 1, 0, 2, 5, True, False, False),      # one dim, one sphere, no interpolation
    (2, 1, 5, 7, 5, True, True, True),        # the point robot: 4-byte rows, no mask words
    (3, 13, 3, 5, 5, True, True, False),      # a planar arm, S not a multiple of 4
    (8, 64, 16, 4, 3, False, True, False),    # the edge of the built range
    (6, 34, 16, 33, 2, False, False, True),   # a long horizon, chunks within a unit
])
def test_assemble_kernel_random_operands(cuda_device, dtype, d, S, T, n, B, planar,
                                         goal_prior, kron):
    """The assembly kernel against its plain version (float64, on the same
    rounded operands): every block within 1e-5 of its norm in float32,
    1e-12 in float64; both forms of the interpolation coefficients."""
    from gpmp2_tpu_torch.ops.assemble import assemble_vec_cuda, assemble_vec_torch

    ops = _assembly_operands(cuda_device, dtype, B, n, d, S, T, planar, seed=d * 100 + S,
                             kron=kron)
    got = assemble_vec_cuda(*ops, goal_prior=goal_prior)
    ref = assemble_vec_torch(*(t.double() if t is not None and t.is_floating_point() else t
                               for t in ops), goal_prior=goal_prior)
    _block_ratio(got, ref, 1e-5 if dtype == torch.float32 else 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_assemble_launch_plan(cuda_device, dtype):
    """The WAM's unit (T + 1 = 10 states) is one chunk in float32; every
    plan of the built range fits a block; outside it the plan raises."""
    from gpmp2_tpu_torch.ops.assemble import launch_plan

    kc, threads, smem = launch_plan(7, 16, 9, dtype)
    assert threads == 256 and smem <= 96 * 1024
    assert kc == 10 or dtype == torch.float64
    for d, S, T in ((1, 1, 0), (8, 64, 16), (8, 1, 16), (1, 64, 0)):
        assert launch_plan(d, S, T, dtype)[2] <= 232448
    for bad in ((9, 16, 9), (7, 65, 9), (7, 16, 17), (0, 16, 9)):
        with pytest.raises(ValueError):
            launch_plan(*bad, dtype)


def _route(monkeypatch, on):
    """Force traj_linearize's choice of the assembly kernel."""
    from gpmp2_tpu_torch.ops import assemble

    real = getattr(assemble.route, "real", assemble.route)

    def forced(*args):
        return on and real(*args)
    forced.real = real
    monkeypatch.setattr(assemble, "route", forced)


def _wam_problems(dev, dtype, B, seed=8, **kw):
    from gpmp2_tpu_torch.planner import (TrajOptimizerSetting, init_traj_straight_line,
                                         make_problem)

    robot = generate_arm("WAMArm", dtype=dtype, device=dev)
    noise = 0.05 * np.random.default_rng(seed).normal(size=(2, B, 7))
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    start = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
    goal = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
    setting = TrajOptimizerSetting(dof=7, total_step=10, total_time=2.0, epsilon=0.2,
                                   cost_sigma=0.02, obs_check_inter=9, opt_type="lm",
                                   max_iter=50, rel_thresh=1e-2, Qc=np.eye(7), **kw)
    zero = torch.zeros((B, 7), dtype=dtype, device=dev)
    probs = make_problem(robot, _ball_field(dev, dtype), f(start + noise[0]), zero,
                         f(goal + noise[1]), zero, setting)
    init = init_traj_straight_line(probs.space, probs.start_pose, probs.end_pose,
                                   setting.total_step, setting.total_time)
    return probs, init, setting


def _perturbed(traj, seed):
    from gpmp2_tpu_torch.planner import Trajectory

    g = torch.Generator().manual_seed(seed)
    noise = [0.1 * torch.randn(traj.pose.shape, generator=g, dtype=torch.float64)
             for _ in range(2)]
    return Trajectory(traj.pose + noise[0].to(traj.pose), traj.vel + noise[1].to(traj.vel))


def _point_problems(dev, dtype):
    """Point robots beside a block on a 4 m field (5 cm cells): lane 0 far
    from the block (every sphere inactive), lane 1 leaving the field (its
    last states out of range)."""
    from gpmp2_tpu_torch.datasets import planar_sdf_from_occupancy
    from gpmp2_tpu_torch.kinematics import PointRobotFK, make_robot_model
    from gpmp2_tpu_torch.planner import (TrajOptimizerSetting, init_traj_straight_line,
                                         make_problem)

    occ = np.zeros((80, 80))
    occ[35:55, 30:50] = 1.0
    sdf = planar_sdf_from_occupancy(np.array([-2.0, -2.0]), 0.05, occ, dtype=dtype, device=dev)
    robot = make_robot_model(PointRobotFK(), [(0, 0.1, (0.0, 0.0, 0.0))], dtype=dtype,
                             device=dev)
    setting = TrajOptimizerSetting(dof=2, total_step=10, total_time=10.0, epsilon=0.2,
                                   cost_sigma=0.1, obs_check_inter=3, opt_type="lm",
                                   Qc=np.eye(2))
    rng = np.random.default_rng(4)
    start = np.array([-1.5, -1.2]) + 0.2 * rng.normal(size=(16, 2))
    goal = np.array([1.5, 1.4]) + 0.2 * rng.normal(size=(16, 2))
    start[0], goal[0] = (-1.8, 1.5), (-1.5, 1.8)
    start[1], goal[1] = (1.5, 1.5), (2.5, 2.5)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    zero = torch.zeros((16, 2), dtype=dtype, device=dev)
    probs = make_problem(robot, sdf, f(start), zero, f(goal), zero, setting)
    return probs, init_traj_straight_line(probs.space, probs.start_pose, probs.end_pose, 10,
                                          10.0)


def _planar_arm_problems(dev, dtype):
    from gpmp2_tpu_torch.datasets import planar_sdf_from_occupancy
    from gpmp2_tpu_torch.planner import (TrajOptimizerSetting, init_traj_straight_line,
                                         make_problem)

    occ = np.zeros((60, 60))
    occ[20:30, 35:45] = 1.0
    sdf = planar_sdf_from_occupancy(np.array([-3.0, -3.0]), 0.1, occ, dtype=dtype, device=dev)
    robot = generate_arm("SimpleThreeLinksArm", dtype=dtype, device=dev)
    setting = TrajOptimizerSetting(dof=3, total_step=10, total_time=5.0, epsilon=0.2,
                                   cost_sigma=0.05, obs_check_inter=5, opt_type="lm",
                                   Qc=np.eye(3))
    rng = np.random.default_rng(6)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    start = f(np.array([-0.5, 0.3, 0.4]) + 0.1 * rng.normal(size=(64, 3)))
    goal = f(np.array([1.2, -0.4, 0.2]) + 0.1 * rng.normal(size=(64, 3)))
    zero = torch.zeros((64, 3), dtype=dtype, device=dev)
    probs = make_problem(robot, sdf, start, zero, goal, zero, setting)
    return probs, init_traj_straight_line(probs.space, start, goal, 10, 5.0)


def _wam_with_limits_and_slots(dev, dtype, B):
    """WAM problems with joint and velocity limits and two replanning slots
    a lane (pins at states 3 and 7, one of them weighted zero)."""
    from gpmp2_tpu_torch.planner import make_problem

    probs, init, setting = _wam_problems(dev, dtype, B, flag_pos_limit=True,
                                         flag_vel_limit=True,
                                         joint_pos_limits_down=-2.0 * np.ones(7),
                                         joint_pos_limits_up=2.0 * np.ones(7),
                                         vel_limits=1.5 * np.ones(7))
    probs = make_problem(probs.robot, probs.sdf, probs.start_pose, probs.start_vel,
                         probs.end_pose, probs.end_vel, setting, num_extra=2)
    idx = torch.tensor([3, 7], device=dev).expand(B, 2).contiguous()
    w = torch.full((B, 2, 7), 50.0, dtype=dtype, device=dev)
    w[:, 1, ::2] = 0.0
    probs = dataclasses.replace(probs, extra_idx=idx, extra_pose=init.pose[:, [3, 7]] + 0.05,
                                extra_vel=init.vel[:, [3, 7]], extra_pose_w=w,
                                extra_vel_w=w.clone())
    return probs, init


ROUTE_CASES = {
    "wam_b1": lambda dev, dt: _wam_problems(dev, dt, 1)[:2],
    "wam_b2048": lambda dev, dt: _wam_problems(dev, dt, 2048)[:2],
    "planar_arm": _planar_arm_problems,
    "point_robot": _point_problems,
    "wam_limits_slots": lambda dev, dt: _wam_with_limits_and_slots(dev, dt, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_assemble_route_matches_twin(cuda_device, monkeypatch, case, dtype):
    """traj_linearize through the assembly kernel against its torch code on
    the card, on the same K2 and K3 outputs, at a perturbed straight line:
    H_diag, H_off, b and err each within 1e-5 of each block's norm in
    float32, 1e-12 in float64; the kernel launches once."""
    from gpmp2_tpu_torch.planner import traj_linearize
    from gpmp2_tpu_torch.utils import trace

    probs, init = ROUTE_CASES[case](cuda_device, dtype)
    traj = _perturbed(init, seed=3)
    _route(monkeypatch, False)
    want = traj_linearize(probs, traj)
    _route(monkeypatch, True)
    before = trace.counters()["launches.assemble"]
    got = traj_linearize(probs, traj)
    assert trace.counters()["launches.assemble"] == before + 1
    _block_ratio(got, want, 1e-5 if dtype == torch.float32 else 1e-12)


@pytest.mark.cuda
def test_assemble_kernel_bit_equal_runs(cuda_device):
    """Two launches on the WAM's main-path shapes (B = 2048) agree bit for
    bit: each output is written once, with no atomics."""
    from gpmp2_tpu_torch.planner import traj_linearize

    probs, init, _ = _wam_problems(cuda_device, torch.float32, 2048)
    traj = _perturbed(init, seed=5)
    a, b = traj_linearize(probs, traj), traj_linearize(probs, traj)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_assemble_launch_counts(cuda_device):
    """`launches.assemble` counts one launch a linearize on a vector space
    (a WAM plan_batch: the attempts plus the initial linearize, as K2 and
    K3; K1 once an attempt) and none on SE(2) (a MobileBaseSE2 linearize,
    which still launches K3)."""
    from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy
    from gpmp2_tpu_torch.planner import (TrajOptimizerSetting, init_traj_straight_line,
                                         make_problem, optimizer_params_from_setting,
                                         plan_batch, traj_linearize)
    from gpmp2_tpu_torch.robots import generate_mobile_base
    from gpmp2_tpu_torch.utils import trace

    probs, init, setting = _wam_problems(cuda_device, torch.float32, 256)
    params = optimizer_params_from_setting(setting)
    trace.reset_counters()
    plan_batch(probs, init, params)
    c = trace.counters()
    assert c["launches.k1"] > 0
    assert c["launches.assemble"] == c["launches.k2"] == c["launches.k3"] == c["launches.k1"] + 1

    ds = generate_2d_dataset("MobileMap1")
    sdf = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=torch.float32,
                                    device=cuda_device)
    se2 = TrajOptimizerSetting(dof=3, total_step=15, total_time=15.0, cost_sigma=0.01,
                               obs_check_inter=3, opt_type="lm", Qc=np.eye(3))
    s = torch.tensor([[-3.0, -3.0, 0.0]] * 8, device=cuda_device)
    g = torch.tensor([[3.0, 3.0, 1.5]] * 8, device=cuda_device)
    mp = make_problem(generate_mobile_base(dtype=torch.float32, device=cuda_device), sdf, s,
                      torch.zeros_like(s), g, torch.zeros_like(g), se2)
    trace.reset_counters()
    traj_linearize(mp, init_traj_straight_line(mp.space, s, g, 15, 15.0))
    c = trace.counters()
    assert c["launches.assemble"] == 0 and c["launches.k3"] == 1


@pytest.mark.cuda
def test_assemble_plan_batch_matches_twin(cuda_device, monkeypatch):
    """plan_batch on the WAM main path (chip_smoke.py's: the 300^3 desk
    field packed, B = 2048 rejection-sampled endpoints, float32) through
    the assembly kernel against the torch route on the same problems: the
    same lanes converge, iterations are equal on at least 99% of the lanes,
    the final errors agree within 3e-5 on at least 99% of the lanes, and
    every lane's final error is the error of its trajectory (traj_error)
    within 3e-5. Two float32 routes that differ in rounding alone leave a
    few lanes' errors further apart (LM stops at a relative decrease of
    1e-2, short of a minimum): the plain version against the torch route
    on the CPU, 512 WAM desk plans, 99th percentile 2.4e-6, largest
    4.9e-4."""
    import chip_smoke
    from gpmp2_tpu_torch.planner import (init_traj_straight_line, make_problem, plan_batch,
                                         traj_error)

    robot, sdf, setting, params, starts, goals = chip_smoke.main_path_inputs(cuda_device)
    zero = torch.zeros_like(starts)
    probs = make_problem(robot, sdf, starts, zero, goals, zero, setting)
    init = init_traj_straight_line(probs.space, starts, goals, setting.total_step,
                                   setting.total_time)
    out = []
    for on in (False, True):
        _route(monkeypatch, on)
        out.append(plan_batch(probs, init, params))
    twin, kernel = out
    assert torch.equal(twin.converged & ~twin.gave_up, kernel.converged & ~kernel.gave_up)
    assert float((twin.iterations == kernel.iterations).float().mean()) >= 0.99

    def gap(a, b):
        return (a.double() - b.double()).abs() / b.double().abs()
    assert float((gap(kernel.error, twin.error) <= 3e-5).float().mean()) >= 0.99
    own = gap(kernel.error, traj_error(probs, kernel.traj))
    assert float(own.max()) <= 3e-5, float(own.max())
