#!/usr/bin/env python3
"""K3's screens at the main path's queries, against other trees' builds, on one NVIDIA GPU.

    python3 tools/time_k3_screens.py [--against DIR ...] [--diagnose]

Builds this tree's kernel library and that of every checkout DIR given
(e.g. the parent commit unpacked with `git archive` into a directory that
.gitignore lists; its package is loaded under an alias and builds into
DIR/build/), then, at the WAM main path's 3,309,568 queries (the sphere
centres of the straight-line inits of chip_smoke.py's B = 2048 problems in
the WAMDeskDataset 300^3 float32 field, packed, each sphere's eps_total as
its threshold), times K3's

- `default`: float32 packed rows, no screen;
- `hull`: the hull screen (the dataset's 12 boxes);
- `coarse`: the coarse screen (factor 8);

each as chip_smoke.py's device_ms (median of REPS launches, each between
two CUDA events behind a spin kernel, the L2 flushed before each), the
trees in turn and then in reverse (this tree, DIR..., DIR..., this tree).
Every tree's outputs are held against this tree's (bit-equal, max |d|),
and this tree's screened queries carry `screen_bound`'s distances and a
zero gradient. With cuobjdump it prints the default instantiation's SASS
line count in each tree and the lines that differ from this tree's, the
kernel's name aside. With --diagnose it also times this tree's hull
screen with the dataset's first 1, 3 and 6 boxes and with all 12 moved
100 m away (every query screened, no row read), each screen with no
query screened (thresholds +inf) and the coarse screen with every query
screened (-inf). One JSON line per result; the last names the card
(`nvidia-smi` name and power limit). Imports no JAX.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (after the path: the repository's own helpers)

REPS = 20  # launches a median

# the default instantiation in the demangled SASS: sdf_lookup_kernel<(int)3,
# float, float, (int)1 (packed)>, or with a last (int)0 (no screen) where
# the screens were instantiations of the same kernel
DEFAULT_KERNEL = re.compile(
    r"sdf_lookup_kernel<(\(int\))?3, float, float, (\(int\))?1(, (\(int\))?0)?>")


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


def default_sass(lib_path):
    """The default instantiation's SASS instructions, addresses and
    encodings stripped, and its mangled name."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    blocks = re.split(r"\n\s*Function : (\S+)\n", text)
    funcs = dict(zip(blocks[1::2], blocks[2::2]))
    names = demangle(list(funcs))
    hits = [m for m, d in names.items() if DEFAULT_KERNEL.search(d)]
    if len(hits) != 1:
        raise AssertionError(f"{lib_path}: {len(hits)} default instantiations")
    lines = []
    for line in funcs[hits[0]].splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s*(.*?)\s*;", line)
        if m:
            lines.append(m.group(1).replace(hits[0], "<name>"))
    return lines, names[hits[0]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[],
                    help="root of another checkout to time beside this one")
    ap.add_argument("--diagnose", action="store_true",
                    help="also time this tree's hull screen with the first 1, 3 and 6 "
                         "boxes and with its boxes far away, and each screen with every "
                         "or no query screened")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_k3_screens: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from gpmp2_tpu_torch import _build
    from gpmp2_tpu_torch.obstacle.sdf import pack_sdf
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

    base_sass, base_name = default_sass(str(_build._library_path()))
    for name, (b, _) in list(trees.items())[1:]:
        sass, other = default_sass(str(b._library_path()))
        diff = [d for d in difflib.unified_diff(base_sass, sass, lineterm="", n=0)
                if d[:1] in "+-" and not d.startswith(("+++", "---"))]
        emit({"sass_default": name, "kernel": other, "lines": len(sass),
              "this_kernel": base_name, "this_lines": len(base_sass),
              "differing_lines": len(diff), "diff": diff[:40]})

    dev = torch.device("cuda", 0)
    inputs = chip_smoke.main_path_inputs(dev)
    robot, sdf, setting, _, starts, goals = inputs
    pts = chip_smoke.main_path_queries(robot, sdf, setting, starts, goals)
    thresh = (robot.sphere_radii + setting.epsilon).contiguous()
    screens = chip_smoke._screens(dev, sdf)
    fields = {"default": pack_sdf(sdf), "hull": pack_sdf(screens["hull"]),
              "coarse": pack_sdf(screens["coarse"])}
    del screens
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
            diffs = [(a.double() - b.double()).nan_to_num().abs().max().item()
                     for a, b in zip(got[:-1], other[:-1])]
            equal = torch.equal(got[-1], other[-1]) and all(
                torch.equal(a.nan_to_num(), b.nan_to_num()) for a, b in zip(got[:-1], other[:-1]))
            emit({"outputs": name, "tree": tree, "bit_equal": equal, "max_abs_diff": max(diffs)})

    order = list(trees) + list(trees)[::-1]
    for name in variants:
        times = {t: [] for t in trees}
        for tree in order:
            times[tree].append(chip_smoke.device_ms(call(trees[tree][1], name),
                                                    reps=REPS, flush=True))
        b = bounds[name]
        for tree, runs in times.items():
            emit({"variant": name, "tree": tree, "N": pts.shape[0],
                  "ms_median": [r[0] for r in runs], "ms_min": [r[1] for r in runs],
                  "ms_max": [r[2] for r in runs], "bound_ms": b[0], "bound_by": b[1],
                  "share_of_bound": [b[0] / r[0] for r in runs]})
    if args.diagnose:
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
    emit({"card": chip_smoke.nvidia_smi_card(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return 0


if __name__ == "__main__":
    sys.exit(main())
