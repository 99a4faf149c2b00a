#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the numbers compared,
for many seeds, in one process (the set-up's imports and kernel build
paid once), with the program as it is or with a control in its place.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--control pack_bf16|reference_bf16]

- pack_bf16: the program's own lower-precision path, its packed 3D table
  stored in bfloat16 (GPMP2_TPU_PACK_DTYPE=bfloat16);
- reference_bf16: the reference in the program's place, computed in
  bfloat16 (the judged plans' cost and collision cost).
One JSON line a seed: correct, attempted, failed and the numbers
compared. The benchmark's own runs never run a control.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", choices=("pack_bf16", "reference_bf16"), default=None)
    args = ap.parse_args(argv)
    if args.control == "pack_bf16":
        os.environ["GPMP2_TPU_PACK_DTYPE"] = "bfloat16"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.execute(spec, args.workload, seed, args.seconds, False,
                              torch.device("cuda"), time.perf_counter(),
                              control=None if args.control == "pack_bf16" else args.control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "failed": out["failed"], "metrics": out["metrics"],
                          "check": {k: v["value"] for k, v in out["check"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
