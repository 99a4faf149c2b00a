#!/usr/bin/env python3
"""How K1's substitution should read the Cholesky factor L, on one NVIDIA GPU.

    python3 tools/time_btsolve_lread.py [--out DIR]

csrc/btsolve.cu's substitution reads the triangle of L twice, once per
sweep. This script builds two variants of that source, which differ only
in the declaration of `L`:

- `plain`:    `const T* L = C;`
- `volatile`: `const volatile T* L = C;` (every read goes to shared memory)

Each is compiled alone with the package's nvcc flags plus `-Xptxas -v`
into DIR/<variant>/ (default DIR: build/btsolve_lread) and loaded with
ctypes. For every kernel instantiation it prints the registers and the
spill stores ptxas reports. Then, at each block size m = 2 ... 36 (float32,
B = 2048, n = 11) and at the shapes the planner's paths give K1, it
checks both variants against the plain PyTorch solve and times them with
CUDA events, in the order plain, volatile, volatile, plain, 30 launches
each after a warm-up. One JSON line per shape: the mean of each variant's
two timings, their ratio, and the card's name and power limit. Imports no
JAX.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the statement that declares L in the substitution
L_DECL = re.compile(r"const (?:volatile )?T\* L = C;")
VARIANTS = {"plain": "const T* L = C;", "volatile": "const volatile T* L = C;"}
# (name, dtype, B, n, m, damped): the block-size sweep, then the paths'
# shapes: PointRobot2D, MultiWorld2D, MobileBaseSE2 (damped and Dogleg's
# lambda = 0), Arm3Limits2D, SimpleTwoLinksArm, the WAM main path at
# B = 2048, 32 and 1, its float64 rescue, and the PR2 in float64 (its
# float32 shape is the sweep's m = 36)
SWEEP = [(f"m{m}", "f32", 2048, 11, m, True) for m in range(2, 37, 2)]
PATHS = [
    ("point_robot", "f32", 16384, 11, 4, True),
    ("multi_world", "f32", 8192, 9, 4, True),
    ("mobile_base", "f32", 4096, 16, 6, True),
    ("mobile_base_lambda0", "f32", 4096, 16, 6, False),
    ("arm3", "f32", 8192, 11, 6, True),
    ("two_links", "f32", 4096, 11, 10, True),
    ("wam_b32", "f32", 32, 11, 14, True),
    ("wam_b1", "f32", 1, 11, 14, True),
    ("wam_f64", "f64", 2048, 11, 14, True),
    ("pr2_f64", "f64", 2048, 11, 36, True),
]


def build(nvcc, flags, src_text, out_dir):
    """Compile one variant of btsolve.cu into a shared library; returns
    (path, ptxas's report)."""
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "btsolve.cu")
    with open(src, "w") as fh:
        fh.write(src_text)
    lib = os.path.join(out_dir, "libbtsolve.so")
    cmd = [nvcc, *flags, "-Xptxas", "-v", "-shared", src, "-o", lib]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ptxas_table(report):
    """{(dtype, m): (registers, spill store bytes)} from `-Xptxas -v`."""
    out, key = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for \S*bt_kernelI([fd])Li(\d+)E", line)
        if m:
            key = ("f32" if m.group(1) == "f" else "f64", int(m.group(2)))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if key and m:
            out[key] = [None, int(m.group(1))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if key and m and key in out:
            out[key][0] = int(m.group(1))
            key = None
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("build", "btsolve_lread"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_btsolve_lread: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from gpmp2_tpu_torch import _build
    from gpmp2_tpu_torch.ops.btsolve import block_tridiag_solve_torch
    from gpmp2_tpu_torch.testing import random_system

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)

    with open(os.path.join(ROOT, "gpmp2_tpu_torch", "csrc", "btsolve.cu")) as fh:
        source = fh.read()
    if len(L_DECL.findall(source)) != 1:
        raise RuntimeError("btsolve.cu: expected one declaration of L in the substitution")
    nvcc = _build._nvcc()
    flags = [*_build._NVCC_FLAGS, "-I", str(_build._CSRC)]
    jobs = {name: build(nvcc, flags, L_DECL.sub(decl, source), os.path.join(args.out, name))
            for name, decl in VARIANTS.items()}
    libs, spills = {}, {}
    for name, (path, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{err}")
        lib = ctypes.CDLL(path)
        lib.gpmp2_btsolve.argtypes = _build._SIGNATURES["gpmp2_btsolve"]
        lib.gpmp2_btsolve.restype = ctypes.c_int
        libs[name] = lib
        spills[name] = ptxas_table(err)
    for key in sorted(spills["plain"]):
        print(json.dumps({"ptxas": f"{key[0]} m={key[1]}",
                          **{f"{v}_regs_spill_bytes": spills[v].get(key) for v in VARIANTS}}),
              flush=True)

    dev = torch.device("cuda", 0)
    for name, dt, B, n, m, damped in SWEEP + PATHS:
        dtype = torch.float32 if dt == "f32" else torch.float64
        D, U, b, lam = (torch.as_tensor(a, dtype=dtype, device=dev)
                        for a in random_system(B, n, m, seed=m, damped=damped,
                                               conditioned=True))
        x_ref = block_tridiag_solve_torch(D.double(), U.double(), b.double(), True,
                                          lam.double())
        tol = (1e-4 if dt == "f32" else 1e-10) * float(x_ref.abs().max())
        x = torch.empty_like(b)
        G = torch.empty_like(D)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def launch(lib):
            rc = lib.gpmp2_btsolve(D.data_ptr(), U.data_ptr(), b.data_ptr(), lam.data_ptr(),
                                   x.data_ptr(), G.data_ptr(), B, n, m, 1,
                                   int(dt == "f64"), stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        for v, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            err = float((x.double() - x_ref).abs().max())
            if not err <= tol:
                raise AssertionError(f"{name} {v}: max|dx| {err} > {tol}")

        def ms(lib, reps=30):
            launch(lib)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                launch(lib)
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / reps

        t = {v: [] for v in VARIANTS}
        for v in ("plain", "volatile", "volatile", "plain"):
            t[v].append(ms(libs[v]))
        mean = {v: sum(ts) / len(ts) for v, ts in t.items()}
        print(json.dumps({"shape": name, "dtype": dt, "B": B, "n": n, "m": m, "damped": damped,
                          "plain_ms": mean["plain"], "volatile_ms": mean["volatile"],
                          "volatile_over_plain": mean["volatile"] / mean["plain"],
                          "runs_ms": t, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
