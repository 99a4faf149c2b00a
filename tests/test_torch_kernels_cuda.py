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
