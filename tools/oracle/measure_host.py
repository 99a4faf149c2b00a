"""Measure the C++ oracle denominators on the host of the machine that holds
the card, and write BASELINE_MEASURED_H100_HOST.json at the repository's
root.

    python3 tools/oracle/measure_host.py [--cpu]

1. Compiles gpmp2_oracle.cpp and gpmp2_oracle_suite.cpp with the
   Makefile's flags (g++ -O3 -march=native -std=c++17) into build/oracle/;
   the tracked binaries beside the sources stay as they are.
2. Runs suite_dump_torch.py into build/oracle_dumps/ (on the card, or with
   --cpu on the CPU): bench_suite.py's seed-0 problem sets.
3. Runs both oracles as BASELINE_MEASURED.json and
   BASELINE_MEASURED_SUITE.json describe, single-threaded, best of 3 by
   planning wall clock (SDF construction excluded): the WAM headline
   protocol (`gpmp2_oracle 512`: rejection-sampled feasible endpoints),
   the WAM suite set (`gpmp2_oracle 512 --probs wam7_probs.bin`) and each
   planar/SE(2) suite config on its dump (`gpmp2_oracle_suite <dump>`).
   The quality columns must be equal in the three runs (the oracle is
   deterministic).
4. Writes the JSON with the host's CPU model and core count (lscpu), the
   card's name and power limit (nvidia-smi; null with --cpu), the date and
   the build flags.

SUITE_BATCH (default 512) sets the number of problems of every set.
Without a CUDA device and without --cpu it exits non-zero.
"""

import datetime
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.normpath(os.path.join(HERE, "..", ".."))
BUILD = os.path.join(REPO, "build", "oracle")
DUMPS = os.path.join(REPO, "build", "oracle_dumps")
OUT = os.path.join(REPO, "BASELINE_MEASURED_H100_HOST.json")
FLAGS = ["-O3", "-march=native", "-std=c++17"]
# bench_suite.py's configs in its order, with their dumps; WAM7_3D runs
# gpmp2_oracle on its raw starts and goals
SUITE = (("PointRobot2D", "pointrobot2d.bin"), ("MobileBaseSE2", "mobilebase_se2.bin"),
         ("Arm3Limits2D", "arm3limits2d.bin"), ("WAM7_3D", "wam7_probs.bin"),
         ("MultiWorld2D", "multiworld2d.bin"))
QUALITY = ("n_plans", "converged", "gave_up", "collision_free", "good")


def build():
    """Both oracles compiled in parallel; their paths."""
    os.makedirs(BUILD, exist_ok=True)
    exes, procs = [], []
    for name in ("gpmp2_oracle", "gpmp2_oracle_suite"):
        exes.append(os.path.join(BUILD, name))
        procs.append(subprocess.Popen(["g++", *FLAGS, os.path.join(HERE, name + ".cpp"),
                                       "-o", exes[-1]]))
    for p in procs:
        if p.wait() != 0:
            raise SystemExit(f"measure_host: {p.args} exited {p.returncode}")
    return exes


def best_of_3(cmd):
    """The oracle's JSON line with the least plan_wall_s of 3 runs, and
    every run's wall time beside it."""
    runs = []
    for _ in range(3):
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    if any(any(r[k] != runs[0][k] for k in QUALITY) for r in runs):
        raise SystemExit(f"measure_host: the oracle's results differ between runs: {runs}")
    best = min(runs, key=lambda r: r["plan_wall_s"])
    best.pop("config", None)  # the dump's path on this machine
    best["plan_wall_s_runs"] = [r["plan_wall_s"] for r in runs]
    print(json.dumps(best), flush=True)
    return best


def lscpu():
    """The host CPU's model and core count, and lscpu's other fields but its
    flags and vulnerability lines (a virtual machine may report the model
    as unknown; vendor, family, model number and caches still say which)."""
    fields = {}
    for line in subprocess.run(["lscpu"], capture_output=True, text=True,
                               check=True).stdout.splitlines():
        key, _, val = line.partition(":")
        if key.strip() and key.strip() != "Flags" and not key.startswith("Vulnerability"):
            fields[key.strip()] = val.strip()
    return {"cpu_model": fields.get("Model name"), "cpus": int(fields["CPU(s)"]),
            "lscpu": fields}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cpu = "--cpu" in argv
    import torch

    if not cpu and not torch.cuda.is_available():
        raise SystemExit("measure_host: no CUDA device; pass --cpu to dump the problem "
                         "sets on the CPU")
    card = None if cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0].strip()
    n = int(os.environ.get("SUITE_BATCH", "512"))
    oracle, oracle_suite = build()
    subprocess.run([sys.executable, os.path.join(HERE, "suite_dump_torch.py"), DUMPS]
                   + (["--cpu"] if cpu else []), check=True)
    wam = best_of_3([oracle, str(n)])
    configs = {}
    for name, dump in SUITE:
        path = os.path.join(DUMPS, dump)
        cmd = ([oracle, str(n), "--probs", path] if name == "WAM7_3D"
               else [oracle_suite, path, str(n)])
        configs[name] = best_of_3(cmd)
    flags = "g++ " + " ".join(FLAGS)
    record = {
        "description": "Single-threaded C++ oracle denominators (tools/oracle/gpmp2_oracle.cpp "
                       "and gpmp2_oracle_suite.cpp) measured on the host CPU of the machine "
                       "that holds the card, by tools/oracle/measure_host.py: `wam` is the "
                       "bench.py headline protocol (rejection-sampled feasible endpoints, "
                       "BASELINE_MEASURED.json's), `configs` the bench_suite.py problem sets "
                       "dumped by tools/oracle/suite_dump_torch.py (BASELINE_MEASURED_SUITE."
                       "json's). Best of 3 runs by planning wall clock, SDF build excluded. "
                       "bench_torch.py's vs_baseline divides by these plans_per_sec.",
        "build": flags, "build_flags": f"{flags} (the Makefile's flags; binaries in "
                                       "build/oracle/)",
        "host": lscpu(), "card": card,
        "date": datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%d"),
        "n_plans": n, "wam": wam, "configs": configs,
    }
    with open(OUT, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
