#!/usr/bin/env python3
"""The benchmark of gpmp2_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration and a traffic mix. The
run builds its inputs from the seed, warms up its own shapes, runs the
mix's closed loop for --seconds, and has the plain reference
(benchmark/reference/) judge a sample of the window's plans. Set-up
parts, the card's nvidia-smi name and power limit, and the numbers
compared (each beside its limit, last) go to standard error; the last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics read from a torch.profiler trace of the window), device, and
with --trace 1 breakdown; then `check`, the numbers compared.

Without a CUDA device, with fewer devices than the cell asks for, or
where a module of JAX or of the JAX package is loaded, it exits non-zero
and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"benchmark: no workload {args.workload!r}", file=sys.stderr)
        return 2
    # the port's host work is one Python thread; torch's CPU thread pool
    # would only contend with it for the host's cores
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    harness.log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
                f"host load {os.getloadavg()}, cores {len(os.sched_getaffinity(0))}")
    out = harness.execute(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda"), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
