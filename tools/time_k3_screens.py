#!/usr/bin/env python3
"""K3's screens or its planar instantiations, against other trees' builds, on one NVIDIA GPU.

    python3 tools/time_k3_screens.py [--against DIR ...] [--planar] [--diagnose]

Builds this tree's kernel library and that of every checkout DIR given
(e.g. the parent commit unpacked with `git archive` into a directory that
.gitignore lists; its package is loaded under an alias and builds into
DIR/build/). With cuobjdump it prints the SASS line count of K3's 3D
default and of both float32 screens (packed rows) in each tree and the
lines that differ from this tree's, the kernel's name aside.

Without --planar, at the WAM main path's 3,309,568 queries (the sphere
centres of the straight-line inits of chip_smoke.py's B = 2048 problems in
the WAMDeskDataset 300^3 float32 field, packed, each sphere's eps_total as
its threshold), it times K3's

- `default`: float32 packed rows, no screen;
- `hull`: the hull screen (the dataset's 12 boxes);
- `coarse`: the coarse screen (factor 8);

and this tree's screened queries must carry `screen_bound`'s distances and
a zero gradient. With --diagnose it also times this tree's hull screen
with the dataset's first 1, 3 and 6 boxes and with all 12 moved 100 m away
(every query screened, no row read), each screen with no query screened
(thresholds +inf) and the coarse screen with every query screened (-inf).

With --planar it times K3's planar instantiations, `row_major` (the
default packed rows) and `corner_major` (the (W, 4, cells) table), on
three query sets in float32:

- `uniform`: phase 15's 999,424 points drawn uniformly over the
  OneObstacle map and a 5% margin ((N, 2), numpy seed 15);
- `planner`: PointRobot2D's planner queries, the sphere centres of the
  straight-line inits of bench_suite.py's B = 16,384 throughput draws, 61
  states each (999,424 queries, (N, 3) as the planner passes them);
- `multiworld`: MultiWorld2D's, the same for its 8,192 worlds of 64^2 at
  33 states a world (270,336 queries, one world per problem).

With --diagnose it also times, in this tree: each pair under a read-only
flush (`read_flush`: a sum over the 256 MB buffer evicts the L2 and leaves
no dirty line); the streaming floor (`floor`: every query at one point, so
one row a world serves all and the time is the points and the outputs)
under both flushes; and a torch copy moving the points' and outputs'
bytes (half read, half written) under both flushes (`copy`), the
achieved-bandwidth line.

Every time is chip_smoke.py's device_ms (median of REPS launches, each
between two CUDA events behind a spin kernel, the L2 flushed before each
by a 256 MB write unless said otherwise), the trees in turn and then in
reverse (this tree, DIR..., DIR..., this tree), beside K3's bound. Every
tree's outputs are held against this tree's (bit-equal, max |d|); with
--planar in float32 and float64, for the row-major and raw layouts and
both of this tree's corner-major routes (interleaved and direct, each
forced), which must also equal this tree's row-major lookup; and
bench_suite.py's PointRobot2D, Arm3Limits2D and MultiWorld2D throughput
sets (and the first two with the corner-major table) are planned with
each tree's K3, the plans compared lane for lane. One JSON
line per result; the last names the card (`nvidia-smi` name and power
limit). Imports no JAX.
"""

import argparse
import difflib
import importlib
import json
import os
import re
import subprocess
import sys
import threading
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (after the path: the repository's own helpers)

REPS = 20  # launches a median

# the instantiations whose SASS must not move, in the demangled names: the
# 3D default sdf_lookup_kernel<(int)3, float, float, (int)1 (packed)> (with
# a last (int)0 where the screens were instantiations of the same kernel),
# and the float32 packed screens sdf_screen_kernel<float, float, (int)1,
# (int)1 (hull) or (int)2 (coarse)>
FIXED_KERNELS = {
    "default": re.compile(
        r"sdf_lookup_kernel<(\(int\))?3, float, float, (\(int\))?1(, (\(int\))?0)?>"),
    "hull": re.compile(r"sdf_screen_kernel<float, float, (\(int\))?1, (\(int\))?1>"),
    "coarse": re.compile(r"sdf_screen_kernel<float, float, (\(int\))?1, (\(int\))?2>"),
}


def emit(row):
    print(json.dumps(row), flush=True)


def load_tree(root, alias):
    """(_build, ops.sdf_lookup) of the checkout at `root`, imported under
    the package name `alias`."""
    pkg = types.ModuleType(alias)
    pkg.__path__ = [os.path.join(root, "gpmp2_tpu_torch")]
    sys.modules[alias] = pkg
    return (importlib.import_module(alias + "._build"),
            importlib.import_module(alias + ".ops.sdf_lookup"))


def demangle(names):
    cufilt = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cu++filt")
    out = subprocess.run([cufilt], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


def kernel_sass(lib_path):
    """{name: (SASS instructions, addresses and encodings stripped; mangled
    name)} of FIXED_KERNELS in the library."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    blocks = re.split(r"\n\s*Function : (\S+)\n", text)
    funcs = dict(zip(blocks[1::2], blocks[2::2]))
    names = demangle(list(funcs))
    out = {}
    for label, pattern in FIXED_KERNELS.items():
        hits = [m for m, d in names.items() if pattern.search(d)]
        if len(hits) != 1:
            raise AssertionError(f"{lib_path}: {len(hits)} {label} instantiations")
        lines = []
        for line in funcs[hits[0]].splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s*(.*?)\s*;", line)
            if m:
                lines.append(m.group(1).replace(hits[0], "<name>"))
        out[label] = (lines, names[hits[0]])
    return out


def outputs_equal(got, other):
    """(bit-equal, max |d|) of two K3 results (dist, grads..., ok)."""
    import torch

    diffs = [(a.double() - b.double()).nan_to_num().abs().max().item()
             for a, b in zip(got[:-1], other[:-1])]
    equal = torch.equal(got[-1], other[-1]) and all(
        torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
        for a, b in zip(got[:-1], other[:-1]))
    return equal, max(diffs)


def time_trees(trees, calls, bounds, extra):
    """Each case of `calls` ({case: {tree: fn}}) timed in every tree, the
    trees in turn and then in reverse; one line a case and tree."""
    order = list(trees) + list(trees)[::-1]
    for case, fns in calls.items():
        times = {t: [] for t in trees}
        for tree in order:
            times[tree].append(chip_smoke.device_ms(fns[tree], reps=REPS, flush=True))
        b = bounds[case]
        for tree, runs in times.items():
            emit({**extra(case), "tree": tree, "ms_median": [r[0] for r in runs],
                  "ms_min": [r[1] for r in runs], "ms_max": [r[2] for r in runs],
                  "bound_ms": b[0], "bound_by": b[1],
                  "share_of_bound": [b[0] / r[0] for r in runs]})


def screens(trees, diagnose):
    """The main path's default and screened lookups (module docstring)."""
    import torch
    from gpmp2_tpu_torch.obstacle.sdf import pack_sdf
    from gpmp2_tpu_torch.ops import sdf_lookup as ops

    dev = torch.device("cuda", 0)
    inputs = chip_smoke.main_path_inputs(dev)
    robot, sdf, setting, _, starts, goals = inputs
    pts = chip_smoke.main_path_queries(robot, sdf, setting, starts, goals)
    thresh = (robot.sphere_radii + setting.epsilon).contiguous()
    fields = chip_smoke._screens(dev, sdf)
    fields = {"default": pack_sdf(sdf), "hull": pack_sdf(fields["hull"]),
              "coarse": pack_sdf(fields["coarse"])}
    kws = {"default": {}, "hull": chip_smoke._variant(fields["hull"], True, thresh),
           "coarse": chip_smoke._variant(fields["coarse"], True, thresh)}
    screened = {}
    for name in ("hull", "coarse"):
        screen = {k: v for k, v in kws[name].items() if k != "corner_major"}
        screened[name] = ops.screen_bound(pts, sdf.origin, sdf.cell_size, **screen)[1]

    bounds = {"default": chip_smoke.k3_bound(pts, fields["default"])}
    for name in ("hull", "coarse"):
        f = fields[name]
        # as phase 15 counts them: the screen's operands read once, its
        # operations a query
        table, flops = ((f.screen_boxes, 22 * f.screen_boxes.shape[0]) if name == "hull"
                        else (f.coarse, 15))
        once = table.numel() * 4 + thresh.numel() * 4
        bounds[name] = chip_smoke.k3_bound(pts, f, read=~screened[name], once_bytes=once,
                                           screen_flops=flops)

    def call(mod, name, kw=None):
        operands = chip_smoke._lookup_operands(fields[name], True)
        kw = kws[name] if kw is None else kw
        return lambda: mod.sdf_lookup_cuda(pts, *operands, **kw)

    variants = ["default", "hull", "coarse"]
    for name in variants:
        got = call(ops, name)()
        torch.cuda.synchronize()
        if name != "default":
            s = screened[name]
            screen = {k: v for k, v in kws[name].items() if k != "corner_major"}
            if not torch.equal(got[1][s], torch.zeros_like(got[1][s])):
                raise AssertionError(f"{name}: a screened query has a gradient")
            if not torch.equal(got[0][s], ops.screen_bound(pts, sdf.origin, sdf.cell_size,
                                                           **screen)[0][s]):
                raise AssertionError(f"{name}: screened distances differ from screen_bound's")
        for tree, (_, mod) in list(trees.items())[1:]:
            other = call(mod, name)()
            torch.cuda.synchronize()
            equal, diff = outputs_equal(got, other)
            emit({"outputs": name, "tree": tree, "bit_equal": equal, "max_abs_diff": diff})

    time_trees(trees, {name: {t: call(m, name) for t, (_, m) in trees.items()}
                       for name in variants}, bounds,
               lambda name: {"variant": name, "N": pts.shape[0]})
    if diagnose:
        inf = torch.full_like(thresh, float("inf"))
        boxes = fields["hull"].screen_boxes
        cases = [(f"hull_boxes{k}", "hull", {"boxes": boxes[:k]}) for k in (1, 3, 6)]
        # every query screened with all 12 boxes: the boxes moved 100 m away
        cases.append(("hull_all", "hull", {"boxes": boxes + 100.0}))
        cases += [(f"{name}_{which}", name, {"thresh": t})
                  for name in ("hull", "coarse") for which, t in (("none", inf), ("all", -inf))
                  if not (name == "hull" and which == "all")]
        for label, name, change in cases:
            kw = {**kws[name], **change}
            screen = {k: v for k, v in kw.items() if k != "corner_major"}
            frac = float(ops.screen_bound(pts, sdf.origin, sdf.cell_size, **screen)[1]
                         .float().mean())
            ms = chip_smoke.device_ms(call(ops, name, kw), reps=REPS, flush=True)
            emit({"diagnose": label, "screened_fraction": frac, "ms_median": ms[0],
                  "ms_min": ms[1], "ms_max": ms[2]})


def planar_sets(dev):
    """{set: (unpacked PlanarSDF, float32 points, queries per world)} of
    the module docstring's three query sets."""
    import torch
    from gpmp2_tpu_torch.datasets import generate_2d_dataset, planar_sdf_from_occupancy
    from gpmp2_tpu_torch.planner import init_traj_straight_line, make_problem
    from gpmp2_tpu_torch.planner.problem import _collision_confs, _spheres_and_jac

    # phase 15's uniform draw (chip_smoke.check_variant_lookups)
    rng = np.random.default_rng(15)
    ds = generate_2d_dataset("OneObstacleDataset")
    field = planar_sdf_from_occupancy(ds.origin, ds.cell_size, ds.map, device=dev)
    ext = np.array([ds.cols, ds.rows]) * ds.cell_size
    uniform = torch.as_tensor(
        ds.origin + rng.uniform(-0.05, 1.05, (chip_smoke.SUITE_BATCH["PointRobot2D"] * 61, 2))
        * ext, dtype=torch.float32, device=dev)
    out = {"uniform": (field, uniform, 0)}
    for name, robot, setting, _, (sdf, s, g), kwargs in chip_smoke.suite_configs(dev, None):
        if name not in ("PointRobot2D", "MultiWorld2D"):
            continue
        z = torch.zeros_like(s)
        probs = make_problem(robot, sdf, s, z, g, z, setting, sdf_pack=False, **kwargs)
        init = init_traj_straight_line(probs.space, s, g, setting.total_step,
                                       setting.total_time)
        centers, _ = _spheres_and_jac(robot, _collision_confs(probs, *init))
        pts = centers.reshape(-1, centers.shape[-1]).contiguous()
        qpw = pts.shape[0] // s.shape[0] if sdf.num_worlds else 0
        out["planner" if name == "PointRobot2D" else "multiworld"] = (sdf, pts, qpw)
    return out


def planar_suite(trees, dev):
    """bench_suite.py's PointRobot2D, Arm3Limits2D and MultiWorld2D
    throughput sets (row-major, and corner-major for the first two, as
    phase 15 runs them) planned with each tree's K3 in turn, the rest of
    the planner this tree's: errors, iterations and converged flags lane
    for lane against this tree's plans."""
    import torch
    from gpmp2_tpu_torch.obstacle.sdf import pack_planar_sdf
    from gpmp2_tpu_torch.planner import init_traj_straight_line, make_problem, plan_batch
    from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting

    this = trees["this"][1]
    own = this.sdf_lookup_cuda
    for name, robot, setting, _, (sdf, s, g), kwargs in chip_smoke.suite_configs(dev, None):
        if name not in ("PointRobot2D", "Arm3Limits2D", "MultiWorld2D"):
            continue
        params = optimizer_params_from_setting(setting)
        z = torch.zeros_like(s)
        for layout in ("row_major", "corner_major")[:1 if sdf.num_worlds else 2]:
            field = pack_planar_sdf(sdf, corner_major=layout == "corner_major")
            probs = make_problem(robot, field, s, z, g, z, setting, **kwargs)
            init = init_traj_straight_line(probs.space, s, g, setting.total_step,
                                           setting.total_time)
            res = {}
            for tree, (_, mod) in trees.items():
                this.sdf_lookup_cuda = mod.sdf_lookup_cuda
                try:
                    res[tree] = plan_batch(probs, init, params)
                finally:
                    this.sdf_lookup_cuda = own
            r0 = res["this"]
            for tree in list(trees)[1:]:
                r = res[tree]
                emit({"suite": [name, layout], "tree": tree, "lanes": int(s.shape[0]),
                      "lanes_equal": torch.equal(r0.error, r.error)
                      and torch.equal(r0.iterations, r.iterations)
                      and torch.equal(r0.converged, r.converged)})


def planar(trees, diagnose):
    """K3's planar instantiations on the three query sets (module docstring)."""
    import torch
    from gpmp2_tpu_torch.obstacle.sdf import pack_planar_sdf

    dev = torch.device("cuda", 0)
    sets = planar_sets(dev)
    calls, bounds, info = {}, {}, {}
    this = trees["this"][1]
    route = this.corner_major_route
    for qset, (field, pts, qpw) in sets.items():
        for layout in ("row_major", "corner_major"):
            f = pack_planar_sdf(field, corner_major=layout == "corner_major")
            operands = chip_smoke._lookup_operands(f, True)
            kw = chip_smoke._variant(f, True)
            case = (qset, layout)
            calls[case] = {t: (lambda m=m, p=pts, o=operands, q=qpw, k=kw:
                               m.sdf_lookup_cuda(p, *o, q, **k))
                           for t, (_, m) in trees.items()}
            # the four corners of the distinct cells read once, 16 B either way
            bounds[case] = chip_smoke.k3_bound(pts, f, qpw=qpw)
            info[case] = {"set": qset, "layout": layout, "N": pts.shape[0],
                          "stride": pts.shape[1], "queries_per_world": qpw,
                          "distinct_rows": bounds[case][2]}
            if layout == "corner_major":
                info[case]["route"] = route(pts.shape[0], max(field.num_worlds, 1),
                                            field.cells, 4)
        # every tree's outputs against this tree's, in float32 and float64:
        # each layout (the raw field too) and each of this tree's
        # corner-major routes (the other tree's as its own chooser picks)
        for dtype in (torch.float32, torch.float64):
            p = pts.to(dtype)
            ref = None
            for layout in ("row_major", "raw", "interleaved", "direct"):
                f = pack_planar_sdf(field.to(dtype=dtype),
                                    corner_major=layout in ("interleaved", "direct"))
                operands = chip_smoke._lookup_operands(f, layout != "raw")
                kw = chip_smoke._variant(f, layout != "raw")
                this.corner_major_route = lambda *a, r=layout: r
                got = this.sdf_lookup_cuda(p, *operands, qpw, **kw)
                this.corner_major_route = route
                torch.cuda.synchronize()
                if ref is None:
                    ref = got
                else:  # the same corners through the same arithmetic
                    equal, diff = outputs_equal(ref, got)
                    emit({"layouts_equal": [qset, "row_major", layout, str(dtype)],
                          "bit_equal": equal, "max_abs_diff": diff})
                for tree, (_, mod) in list(trees.items())[1:]:
                    equal, diff = outputs_equal(got, mod.sdf_lookup_cuda(p, *operands, qpw,
                                                                         **kw))
                    emit({"outputs": [qset, layout, str(dtype)], "tree": tree,
                          "bit_equal": equal, "max_abs_diff": diff})
    time_trees(trees, calls, bounds, lambda case: {"planar": case, **info[case]})
    if len(trees) > 1:
        planar_suite(trees, dev)
    if not diagnose:
        return
    for qset, (field, pts, qpw) in sets.items():
        N = pts.shape[0]
        # every query at the field's first cell centre (x and y), one row a world
        one = pts.clone()
        one[:, :2] = field.origin + 0.5 * field.cell_size
        nbytes = pts.numel() * 4 + N * (3 * 4 + 1)
        src = torch.zeros(nbytes // 8, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)
        for flush in (True, "read"):
            flush_name = "write" if flush is True else "read"
            ms = chip_smoke.device_ms(lambda: dst.copy_(src), reps=REPS, flush=flush)
            emit({"diagnose": "copy", "set": qset, "flush": flush_name, "bytes": nbytes,
                  "ms_median": ms[0], "ms_min": ms[1], "ms_max": ms[2],
                  "tb_per_s": nbytes / ms[0] / 1e9})
            for layout in ("row_major", "corner_major"):
                f = pack_planar_sdf(field, corner_major=layout == "corner_major")
                operands = chip_smoke._lookup_operands(f, True)
                kw = chip_smoke._variant(f, True)
                for label, p in (("lookup", pts), ("floor", one)):
                    if label == "lookup" and flush is True:
                        continue  # timed above against the other trees
                    ms = chip_smoke.device_ms(
                        lambda p=p: this.sdf_lookup_cuda(p, *operands, qpw, **kw),
                        reps=REPS, flush=flush)
                    emit({"diagnose": label, "set": qset, "layout": layout,
                          "flush": flush_name, "N": N, "ms_median": ms[0], "ms_min": ms[1],
                          "ms_max": ms[2]})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[],
                    help="root of another checkout to time beside this one")
    ap.add_argument("--planar", action="store_true",
                    help="time the planar instantiations (row-major and corner-major) "
                         "in place of the main path's screens")
    ap.add_argument("--diagnose", action="store_true",
                    help="also time this tree's diagnostic cases (module docstring)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_k3_screens: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from gpmp2_tpu_torch import _build
    from gpmp2_tpu_torch.ops import sdf_lookup as ops

    trees = {"this": (_build, ops)}
    for k, root in enumerate(args.against):
        trees[f"against{k}:{os.path.basename(os.path.normpath(root))}"] = load_tree(
            os.path.abspath(root), f"k3_tree{k}")
    errors = []

    def build(b):
        try:
            b.kernels_lib()
        except Exception as e:  # noqa: BLE001  (re-raised below, after every build)
            errors.append(e)

    threads = [threading.Thread(target=build, args=(b,)) for b, _ in trees.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]

    base = kernel_sass(str(_build._library_path()))
    for name, (b, _) in list(trees.items())[1:]:
        other = kernel_sass(str(b._library_path()))
        for label, (sass, kernel) in other.items():
            this_sass, this_kernel = base[label]
            diff = [d for d in difflib.unified_diff(this_sass, sass, lineterm="", n=0)
                    if d[:1] in "+-" and not d.startswith(("+++", "---"))]
            emit({f"sass_{label}": name, "kernel": kernel, "lines": len(sass),
                  "this_kernel": this_kernel, "this_lines": len(this_sass),
                  "differing_lines": len(diff), "diff": diff[:40]})

    (planar if args.planar else screens)(trees, args.diagnose)
    emit({"card": chip_smoke.nvidia_smi_card(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return 0


if __name__ == "__main__":
    sys.exit(main())
