"""The opt-in SDF variants against the JAX package, on the CPU.

The coarse screen (`screen_sdf`), the hull screen (`screen_boxes`,
`dataset_screen_boxes`), float16 and bfloat16 packed tables and the
corner-major planar table go through both packages on the same small
fields, made from numpy: a 40^3 world of two boxes, random planar grids.
Tables must be bit-equal and lookups agree at rtol 1e-12 in float64; the
screened planner must equal the unscreened one and the JAX package's.
On the CPU the port runs kernel K3's plain version (ops/sdf_lookup.py);
tests/test_torch_kernels_cuda.py holds the kernel's variants to it on a
card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpmp2_tpu.datasets import generate3d as j_gen3d
from gpmp2_tpu.datasets import sdf_gen as j_sdf_gen
from gpmp2_tpu.obstacle import sdf as jsdf
from gpmp2_tpu.planner import batch as j_batch
from gpmp2_tpu.planner.problem import Trajectory as JTrajectory
from gpmp2_tpu.planner.problem import traj_linearize as j_traj_linearize
from gpmp2_tpu.robots import generate_arm as j_generate_arm
from gpmp2_tpu_torch.datasets import generate_3d_dataset, sdf_gen
from gpmp2_tpu_torch.obstacle import sdf as tsdf
from gpmp2_tpu_torch.planner import batch as t_batch
from gpmp2_tpu_torch.planner.problem import traj_linearize
from gpmp2_tpu_torch.planner.traj_utils import init_traj_straight_line
from gpmp2_tpu_torch.robots import generate_arm
from gpmp2_tpu_torch.utils.convert import planar_sdf_from_numpy, sdf_from_numpy
from test_torch_linearize import wam_setting

F64 = torch.float64
N = 40  # the box world's grid
CELL = 0.05
W = 3  # worlds of a per-problem planar field
TORCH = {jnp.float32: torch.float32, jnp.float64: F64, jnp.float16: torch.float16,
         jnp.bfloat16: torch.bfloat16}


@functools.lru_cache(maxsize=None)
def box_dataset():
    """Two boxes in a 40^3 grid over [-1, 1)^3 (generate3d's layout)."""
    occ = np.zeros((N, N, N))
    occ, corner = j_gen3d.add_obstacle_3d([12, 25, 20], [7, 9, 5], occ)
    occ, corner = j_gen3d.add_obstacle_3d([30, 12, 28], [9, 5, 11], occ, corner)
    return j_gen3d.Dataset3D(occ, N, N, N, -1.0, -1.0, -1.0, CELL, corner)


def box_fields(dtype=jnp.float64, boxes=True):
    """The JAX box world (with its hull boxes) and the port's, built from
    the JAX field's arrays."""
    ds = box_dataset()
    hulls = j_sdf_gen.dataset_screen_boxes(ds) if boxes else None
    j = j_sdf_gen.sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, dtype=dtype,
                                     screen_boxes=hulls)
    t = sdf_from_numpy(*(np.asarray(x) for x in (j.origin, j.cell_size, j.data)),
                       screen_boxes=None if hulls is None else np.asarray(j.screen_boxes),
                       dtype=TORCH[dtype], device="cpu")
    return j, t


def box_queries(shape, seed):
    """Points over the grid and a margin outside it, one of them NaN."""
    pts = np.random.default_rng(seed).uniform(-1.1, 1.1, shape + (3,))
    pts.reshape(-1, 3)[0, 0] = np.nan
    return pts


def assert_lookup_equal(got, ref, rtol=1e-12):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol, atol=1e-14)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("factor", [8, 7])  # 40 - 1 = 39 cells: 7 does not divide
def test_screen_sdf_bit_equal_to_jax(dtype, factor):
    j, t = box_fields(dtype, boxes=False)
    j, t = jsdf.screen_sdf(j, factor), tsdf.screen_sdf(t, factor)
    assert t.coarse.shape == (-(-(N - 1) // factor),) * 3 and t.coarse.dtype == TORCH[dtype]
    np.testing.assert_array_equal(t.coarse.numpy(), np.asarray(j.coarse))
    np.testing.assert_array_equal(t.coarse_cell.numpy(), np.asarray(j.coarse_cell))


def test_dataset_screen_boxes_match_jax():
    ds_j = j_gen3d.generate_3d_dataset("WAMDeskDataset")
    ds_t = generate_3d_dataset("WAMDeskDataset")
    want = j_sdf_gen.dataset_screen_boxes(ds_j)
    got = sdf_gen.dataset_screen_boxes(ds_t)
    assert got.shape == want.shape == (len(ds_j.corner_idx), 2, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sdf_gen.dataset_screen_boxes(ds_t, np.float32),
                                  j_sdf_gen.dataset_screen_boxes(ds_j, np.float32))


def test_sdf_from_occupancy_carries_screen_boxes():
    ds = box_dataset()
    hulls = j_sdf_gen.dataset_screen_boxes(ds)
    j, _ = box_fields(jnp.float32)
    t = sdf_gen.sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, screen_boxes=hulls,
                                   device="cpu")
    assert t.screen_boxes.dtype == torch.float32
    np.testing.assert_array_equal(t.screen_boxes.numpy(), np.asarray(j.screen_boxes))
    np.testing.assert_allclose(t.data.numpy(), np.asarray(j.data), atol=1e-6)


@pytest.mark.parametrize("narrow", [jnp.float16, jnp.bfloat16])
def test_narrow_pack_bit_equal_to_jax(narrow):
    j, t = box_fields(jnp.float32, boxes=False)
    j, t = jsdf.pack_sdf(j, dtype=narrow), tsdf.pack_sdf(t, TORCH[narrow])
    assert t.packed.dtype == TORCH[narrow] and t.packed.shape == (N ** 3, 8)
    np.testing.assert_array_equal(t.packed.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(j.packed).view(np.uint16))


@pytest.mark.parametrize("narrow", [jnp.float16, jnp.bfloat16])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_narrow_lookup_matches_jax(narrow, dtype):
    """Both convert the narrow corners to the query type, then run the same
    arithmetic: 1e-6 in float32 (FMA-free CPU arithmetic on both sides
    gives equal bits here), 1e-12 in float64."""
    j, t = box_fields(dtype, boxes=False)
    j, t = jsdf.pack_sdf(j, dtype=narrow), tsdf.pack_sdf(t, TORCH[narrow])
    pts = box_queries((600,), seed=2).astype(np.float32 if dtype == jnp.float32
                                              else np.float64)
    ref = jax.jit(jsdf.sdf_lookup)(j, jnp.asarray(pts))
    got = tsdf.sdf_lookup(t, torch.from_numpy(pts))
    assert got[0].dtype == TORCH[dtype]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   rtol=1e-6 if dtype == jnp.float32 else 1e-12,
                                   atol=1e-6 if dtype == jnp.float32 else 1e-14)


def planar_fields(worlds, rows=5, cols=4, seed=0):
    """A random planar field ([W,] rows, cols) in both packages, float64."""
    shape = ((worlds,) if worlds else ()) + (rows, cols)
    data = np.random.default_rng(seed).normal(size=shape)
    origin = np.array([-0.25, 0.5])
    j = jsdf.PlanarSDF(jnp.asarray(origin), jnp.asarray(0.125), jnp.asarray(data))
    t = planar_sdf_from_numpy(origin, 0.125, data, dtype=F64, device="cpu")
    return j, t


def planar_queries(worlds, n, rows=5, cols=4, seed=1):
    shape = ((worlds,) if worlds else ()) + (n, 2)
    ext = np.array([cols, rows]) * 0.125
    pts = np.array([-0.25, 0.5]) + np.random.default_rng(seed).uniform(-0.1, 1.1, shape) * ext
    pts.reshape(-1, 2)[0, 1] = np.nan
    return pts


@pytest.mark.parametrize("worlds", [0, W])
def test_corner_major_pack_bit_equal_to_jax(worlds):
    j, t = planar_fields(worlds)
    j, t = (jsdf.pack_planar_sdf(j, corner_major=True),
            tsdf.pack_planar_sdf(t, corner_major=True))
    assert t.corner_major and t.packed.shape == ((worlds,) if worlds else ()) + (4, 20)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    # a JAX table carries across with its layout
    c = planar_sdf_from_numpy(np.asarray(j.origin), 0.125, np.asarray(j.data),
                              np.asarray(j.packed), dtype=F64, device="cpu")
    assert c.corner_major


@pytest.mark.parametrize("worlds", [0, W])
def test_corner_major_lookup_equals_row_major(worlds):
    """The same corners through the same arithmetic: the corner-major
    lookup equals the row-major one, and the JAX package's corner-major
    lookup (vmapped over the worlds)."""
    j, t = planar_fields(worlds)
    cm, rm = (tsdf.pack_planar_sdf(t, corner_major=True), tsdf.pack_planar_sdf(t))
    pts = torch.from_numpy(planar_queries(worlds, 300))
    got = tsdf.sdf_lookup_points(cm, pts)
    for g, r in zip(got, tsdf.sdf_lookup_points(rm, pts)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-12, atol=1e-14)
    jcm = jsdf.pack_planar_sdf(j, corner_major=True)

    def one(data, packed, p):
        return jsdf.planar_sdf_lookup_components(jcm._replace(data=data, packed=packed),
                                                 p[..., 0], p[..., 1])

    fn = jax.vmap(one) if worlds else one
    assert_lookup_equal(got, jax.jit(fn)(jcm.data, jcm.packed, jnp.asarray(pts.numpy())))


def test_corner_major_lookup_of_any_table_matches_jax():
    """A (4, cells) table that no packing built (its corners unrelated to
    the field): the port's plain corner-major lookup reads corner k of cell
    l at [k, l], as JAX's planar_sdf_lookup_components does."""
    j, t = planar_fields(0)
    table = np.random.default_rng(9).normal(size=(4, t.cells))
    jt = j._replace(packed=jnp.asarray(table))
    tt = dataclasses.replace(t, packed=torch.from_numpy(table), corner_major=True)
    pts = planar_queries(0, 300)
    ref = jax.jit(jsdf.planar_sdf_lookup_components)(jt, jnp.asarray(pts[:, 0]),
                                                     jnp.asarray(pts[:, 1]))
    got = tsdf.sdf_lookup_points(tt, torch.from_numpy(pts))
    assert_lookup_equal(got, ref)
    # the table, not the field, gives the distances
    assert np.abs(got[0].numpy() - tsdf.sdf_lookup_points(t, torch.from_numpy(pts))[0]
                  .numpy())[1:].max() > 0.1


@pytest.mark.parametrize("itemsize,worlds,cells,N,route", [
    (4, 1, 90_000, 999_424, "interleaved"),  # PointRobot2D on OneObstacle
    (4, 8192, 4096, 270_336, "direct"),  # MultiWorld2D
    (4, 1, 90_000, 61, "direct"),  # one PointRobot2D problem
    (4, 1, 90_000, 73_690, "direct"), (4, 1, 90_000, 73_691, "interleaved"),
    (4, 1, 2000, 44_357, "direct"), (4, 1, 2000, 44_358, "interleaved"),
    (8, 1, 2000, 45_023, "direct"), (8, 1, 2000, 45_024, "interleaved")])
def test_corner_major_route(itemsize, worlds, cells, N, route):
    """The kernel's route for a corner-major table: interleaved where
    copying the table (8 * itemsize bytes a cell) and a launch (4 MB of
    memory time) cost no more than the three extra 32-B sectors a query
    of the direct reads."""
    from gpmp2_tpu_torch.ops.sdf_lookup import corner_major_route

    assert corner_major_route(N, worlds, cells, itemsize) == route


def test_corner_major_2x2_world_quirk():
    """JAX tells the layouts apart by shape, and reads the corner-major
    table of a 2 x 2 world, (4, 4), as row-major: its distances differ from
    its own unpacked lookup. The port carries the layout and answers as
    the unpacked lookup does."""
    j, t = planar_fields(0, rows=2, cols=2, seed=4)
    pts = np.array([[-0.2, 0.55], [-0.15, 0.6], [-0.2, 0.6], [-0.13, 0.52]])
    raw = jax.jit(jsdf.planar_sdf_lookup)(j, jnp.asarray(pts))
    quirk = jax.jit(jsdf.planar_sdf_lookup)(jsdf.pack_planar_sdf(j, corner_major=True),
                                            jnp.asarray(pts))
    assert np.abs(np.asarray(quirk[0]) - np.asarray(raw[0])).max() > 0.1
    got = tsdf.planar_sdf_lookup(tsdf.pack_planar_sdf(t, corner_major=True),
                                 torch.from_numpy(pts))
    assert_lookup_equal(got, raw)


def screened_fields(screen):
    """The box world with the hull screen, the coarse screen or both, in
    both packages (float64)."""
    j, t = box_fields(boxes=screen != "coarse")
    if screen != "hull":
        j, t = jsdf.screen_sdf(j), tsdf.screen_sdf(t)
    return j, t


@pytest.mark.parametrize("screen", ["hull", "coarse", "both"])
@pytest.mark.parametrize("thresh", ["scalar", "per_sphere"])
def test_screened_lookup_matches_jax(screen, thresh):
    """dist, grad and ok of the screened lookup against the JAX package's
    (tests/test_sdf.py::TestScreened, ::TestBoxScreen), with a scalar and a
    per-sphere threshold over a trailing sphere axis; the screen skips
    rows, and the hinge equals the unscreened one."""
    j, t = screened_fields(screen)
    pts = box_queries((512, 4), seed=6)
    th = 0.25 if thresh == "scalar" else np.array([0.1, 0.2, 0.3, 0.05])
    ref = jax.jit(jsdf.sdf_lookup)(j, jnp.asarray(pts), jnp.asarray(th))
    got = tsdf.sdf_lookup(t, torch.from_numpy(pts), torch.as_tensor(th))
    assert_lookup_equal(got, ref)
    plain = tsdf.sdf_lookup(dataclasses.replace(t, coarse=None, coarse_cell=None,
                                                screen_boxes=None), torch.from_numpy(pts))
    fin = torch.isfinite(plain[0])
    assert float((got[0] != plain[0])[fin].double().mean()) > 0.3
    th_t = torch.as_tensor(th).expand(512, 4)
    hinge = [torch.where(ok & (d <= th_t), th_t - d, 0.0) for d, _, ok in (got, plain)]
    torch.testing.assert_close(hinge[0], hinge[1], rtol=0, atol=0)


def test_screen_thresh_forms():
    """A threshold per query (broadcast to the full query shape) equals the
    per-sphere vector, and thresholds that do not broadcast raise."""
    _, t = screened_fields("hull")
    pts = torch.from_numpy(box_queries((64, 4), seed=8))
    th = torch.tensor([0.1, 0.2, 0.3, 0.05], dtype=F64)
    full = tsdf.sdf_lookup_points(t, pts, th.expand(64, 4).clone())
    for a, b in zip(full, tsdf.sdf_lookup_points(t, pts, th)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError):
        tsdf.sdf_lookup_points(t, pts, torch.zeros(5, dtype=F64))


def _wam_problems(jsdf_field, tsdf_field, B=2):
    setting = wam_setting(total_step=4, inter=2)
    rng = np.random.default_rng(3)
    base_s = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
    base_g = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
    s = base_s + 0.05 * rng.normal(size=(B, 7))
    g = base_g + 0.05 * rng.normal(size=(B, 7))
    z = np.zeros_like(s)
    jp = j_batch.make_problem(j_generate_arm("WAMArm", dtype=jnp.float64), jsdf_field,
                              s, z, g, z, setting, dtype=jnp.float64, sdf_pack=False)
    tp = t_batch.make_problem(generate_arm("WAMArm", dtype=F64, device="cpu"), tsdf_field,
                              torch.from_numpy(s), torch.from_numpy(z),
                              torch.from_numpy(g), torch.from_numpy(z), setting,
                              sdf_pack=False)
    template = j_batch.make_problem(j_generate_arm("WAMArm", dtype=jnp.float64), jsdf_field,
                                    s[0], z[0], g[0], z[0], setting, dtype=jnp.float64,
                                    sdf_pack=False)
    return setting, jp, tp, j_batch.infer_batch_axes(jp, template)


@pytest.mark.parametrize("screen", ["hull", "coarse"])
def test_screened_planner_matches_unscreened_and_jax(screen):
    """traj_linearize and plan_batch of a small WAM problem in the box world
    (the WAM's spheres reach the boxes) with the screen on: equal to the
    unscreened run, and to the JAX package's screened run at the
    linearize and planner tests' tolerances."""
    j, t = screened_fields(screen)
    setting, jp, tp, axes = _wam_problems(j, t)
    _, _, tp0, _ = _wam_problems(j, dataclasses.replace(
        t, coarse=None, coarse_cell=None, screen_boxes=None))
    init = init_traj_straight_line(tp.space, tp.start_pose, tp.end_pose,
                                   setting.total_step, setting.total_time)
    lin, lin0 = traj_linearize(tp, init), traj_linearize(tp0, init)
    jinit = JTrajectory(jnp.asarray(init.pose.numpy()), jnp.asarray(init.vel.numpy()))
    jlin = jax.jit(jax.vmap(j_traj_linearize, in_axes=(axes, 0)))(jp, jinit)
    for a, b, r in zip(lin, lin0, jlin):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-9, atol=1e-9)
    assert float(lin[-1].min()) > 0  # obstacle hinges are active on the line

    params = t_batch.optimizer_params_from_setting(setting)
    res, res0 = t_batch.plan_batch(tp, init, params), t_batch.plan_batch(tp0, init, params)
    torch.testing.assert_close(res.error, res0.error, rtol=0, atol=0)
    assert torch.equal(res.iterations, res0.iterations)
    ref = j_batch.plan_batch(jp, jinit, dataclasses.replace(
        j_batch.optimizer_params_from_setting(setting), loop="static"), axes)
    np.testing.assert_allclose(res.error.numpy(), np.asarray(ref.error), rtol=1e-6)
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))


@pytest.mark.parametrize("pack_dtype,budget", [
    ("float16", None), ("bfloat16", None), ("none", None), ("auto", None), ("", None),
    ("float16", N ** 3 * 8 * 8 - 1), ("float16", N ** 3 * 8 * 8)])
def test_make_problem_pack_options_match_jax(monkeypatch, pack_dtype, budget):
    """GPMP2_TPU_PACK_DTYPE and GPMP2_TPU_SDF_PACK_BUDGET: whether
    make_problem packs a 3D field, and in which type, as the JAX package
    decides (the budget counts the field's float64 bytes times 8). A planar
    field packs at full width whatever the type."""
    monkeypatch.setenv("GPMP2_TPU_PACK_DTYPE", pack_dtype)
    if budget is None:
        monkeypatch.delenv("GPMP2_TPU_SDF_PACK_BUDGET", raising=False)
    else:
        monkeypatch.setenv("GPMP2_TPU_SDF_PACK_BUDGET", str(budget))
    j, t = box_fields(boxes=False)
    jp = j_batch._maybe_pack_sdf(j, None)
    tp = t_batch._maybe_pack_sdf(t, None)
    assert (tp.packed is None) == (jp.packed is None)
    if tp.packed is not None:
        assert tp.packed.dtype == TORCH[jp.packed.dtype.type]
        np.testing.assert_array_equal(tp.packed.float().numpy(),
                                      np.asarray(jp.packed).astype(np.float32))
    jq, tq = planar_fields(0)
    assert t_batch._maybe_pack_sdf(tq, None).packed.dtype == F64
    assert j_batch._maybe_pack_sdf(jq, None).packed.dtype == jnp.float64


def test_narrow_table_survives_casts_and_rescue_drops_it():
    """`to` keeps a narrow table narrow; the float64 rescue's field (packed
    dropped, cast to float64) keeps the screen; a bad pack type raises."""
    _, t = box_fields(jnp.float32)
    p = tsdf.pack_sdf(tsdf.screen_sdf(t), torch.float16)
    p64 = p.to(dtype=F64)
    assert p64.packed.dtype == torch.float16 and p64.data.dtype == F64
    assert p64.coarse.dtype == F64 and p64.screen_boxes.dtype == F64
    raw = dataclasses.replace(p, packed=None).to(F64)
    assert raw.packed is None and raw.coarse is not None
    pts = torch.from_numpy(box_queries((200,), seed=9))
    for a, b in zip(tsdf.sdf_lookup(p64, pts), tsdf.sdf_lookup(
            tsdf.pack_sdf(t.to(dtype=F64), torch.float16), pts)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError):
        tsdf.pack_sdf(t, torch.float64)


def test_sdf_from_numpy_takes_jax_variants():
    """A JAX field's narrow table (float16 and bfloat16), coarse table and
    hull boxes carry across and look up as in the JAX package."""
    j, _ = box_fields()
    pts = box_queries((300,), seed=10)
    for narrow in (jnp.float16, jnp.bfloat16):
        js = jsdf.screen_sdf(jsdf.pack_sdf(j, dtype=narrow))
        t = sdf_from_numpy(*(np.asarray(x) for x in (js.origin, js.cell_size, js.data,
                                                     js.packed)),
                           coarse=np.asarray(js.coarse), coarse_cell=np.asarray(js.coarse_cell),
                           screen_boxes=np.asarray(js.screen_boxes), dtype=F64, device="cpu")
        assert t.packed.dtype == TORCH[narrow]
        ref = jax.jit(jsdf.sdf_lookup)(js, jnp.asarray(pts), jnp.asarray(0.2))
        assert_lookup_equal(tsdf.sdf_lookup(t, torch.from_numpy(pts), 0.2), ref)


@pytest.mark.parametrize("bad", ["worlds_with_screen", "planar_narrow", "boxes_shape",
                                 "coarse_without_cell"])
def test_bad_variant_fields_raise(bad):
    _, t = box_fields()
    with pytest.raises(ValueError):
        if bad == "worlds_with_screen":
            tsdf.SignedDistanceField(t.origin, t.cell_size, t.data[None].expand(2, N, N, N),
                                     screen_boxes=t.screen_boxes)
        elif bad == "planar_narrow":
            _, tq = planar_fields(0)
            tq = tsdf.pack_planar_sdf(tq)
            dataclasses.replace(tq, packed=tq.packed.to(torch.float16))
        elif bad == "boxes_shape":
            dataclasses.replace(t, screen_boxes=t.screen_boxes[:, :, :2])
        else:
            dataclasses.replace(t, coarse=tsdf.screen_sdf(t).coarse)
