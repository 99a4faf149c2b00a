#!/usr/bin/env python3
"""The port's benchmark: the twins of bench.py, bench_suite.py,
bench_replan.py and bench_longhorizon.py on one NVIDIA GPU.

    python3 bench_torch.py [--config {main,suite,replan,longhorizon,all}]
                           [--cpu] [--seed S] [--repeats R] [--out PATH]

Each mode prints one JSON line per row, under its JAX twin's metric and
column names, with `mode`, the device it ran on, and `card`: the card's
name and power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them (null with --cpu). The workloads are
chip_smoke.py's workload functions, imported, not copied:

- main (bench.py): WAM 7-DOF in the WAMDeskDataset 300^3 SDF (float32,
  packed once), B = 2048 endpoints rejection-sampled from numpy seed 0
  (main_path_inputs), LM with bench.py's setting; a warm-up, then R = 3
  timed solves, the best of R. Metric `wam7_converged_plans_per_sec_per_chip`:
  converged, not given up and collision-free (eps = 0 cost below 1e-4)
  plans per second; warm latency at B = 1 and 32.
- suite (bench_suite.py): its five configs in its order (suite_configs).
  For each, the q512 set (numpy seed 0, the oracle's problems) solved with
  the float64 rescue, its fractions beside the oracle's
  (BASELINE_MEASURED_SUITE.json), then throughput at the config's own
  batch (seed 1), rescue off, best of R after a warm-up.
- replan (bench_replan.py): B = 1024 WAM sessions, an untimed cold update
  and warm-up round, then 8 timed rounds of pins, state estimates and goal
  moves (wam_fleet_sessions). Metric `wam7_session_updates_per_sec_per_chip`.
- longhorizon (bench_longhorizon.py): its random SPD systems (numpy seed
  0, B = 256, m = 14, float32) at n = 65, 129, 257 and 1025, K1 against
  the partitioned solve with P = max(2, min(64, n // 64)); one line per
  (n, solver) with host ms (best of R), device ms and the worst lane's
  relative residual (lh_rows).
- all: the four in that order, sharing the WAM field.

Departures from the JAX scripts, on purpose:
(a) The main mode's timed window ends at a host copy of what a caller
    uses: the trajectory, error, iterations, converged, gave_up and the
    collision costs, for the throughput solves and the latency rows alike
    (bench.py's latency rows fetched only error and converged).
(b) Every timed repeat's time is printed (`times_s`, `times_ms`), with the
    median beside the best: host-clock figures move between runs of the
    same code, and a benchmark needs the spread.
(c) The JAX-only columns are gone (`loop`, `latency_note`, the tunnel's
    remarks); `compile_s` is `warmup_s`, the first (untimed) solve.
The long-horizon mode writes no file; with --out every row goes to one
JSON file, which must lie under the repository's git-ignored build/.

`vs_baseline` divides plans/s by the single-threaded C++ oracle's plans/s
measured on the same machine's host, BASELINE_MEASURED_H100_HOST.json
(tools/oracle/measure_host.py); without that file it is null.

Gates (the run exits non-zero; a quality gate after printing its row): on
the card every row must launch the kernels of its path in its last timed
repeat (K1, K2 and K3 in main, replan and the arm suite configs; K1 and
K3 in the other suite configs; K1 in longhorizon), as `launches` shows
(in replan every timed round must); main must reach
0.95 converged and 0.99 collision-free among the converged; each suite
config's q512 converged fraction must reach the oracle's and its
collision-free fraction lie within 0.02 of it (on the oracle's 512
problems only, so not at another SUITE_BATCH). No failure is caught.

Knobs (the JAX scripts' names): BENCH_BATCH (main 2048, replan 1024),
BENCH_REPEATS (R, default 3; --repeats wins), BENCH_ROUNDS (8),
SUITE_BATCH (the q512 sets, 512), SUITE_B_POINT, SUITE_B_MOBILE,
SUITE_B_ARM3, SUITE_B_WAM, SUITE_B_MULTI (throughput batches), LH_BATCH
(256), LH_NS (the long-horizon n, comma-separated; 65,129,257,1025).
--seed replaces the seeds of the main endpoints, the suite's
throughput draws, the replanning fleet and the long-horizon systems; the
q512 sets stay the oracle's. Without a CUDA device and without --cpu the
script exits non-zero with the port's "no CUDA device" message; with --cpu
the kernels' plain versions run and count no launches.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

HOST_BASELINE = os.path.join(REPO, "BASELINE_MEASURED_H100_HOST.json")
CONFIGS = ("main", "suite", "replan", "longhorizon")


def env_int(name, default):
    return int(os.environ.get(name, str(default)))


def env_ints(name, default):
    """A comma-separated list of ints from the environment, else `default`."""
    value = os.environ.get(name)
    return default if value is None else tuple(int(v) for v in value.split(","))


def host_baseline():
    """The oracle's plans/s measured on this machine's host, or None."""
    try:
        with open(HOST_BASELINE) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return None


def ratio(value, base):
    return None if base is None else value / base


def spread(times):
    return min(times), float(np.median(times))


class Bench:
    """One run's device, card line, seeds, repeats and rows."""

    def __init__(self, dev, card, seed, repeats):
        self.dev, self.card, self.seed, self.repeats = dev, card, seed, repeats
        self.rows = []
        self.baseline = host_baseline()
        self._wam = None

    def seed_or(self, default):
        return default if self.seed is None else self.seed

    def emit(self, mode, row):
        import torch

        row = {"mode": mode, **row, "device": (torch.cuda.get_device_name(self.dev)
                                               if self.dev.type == "cuda" else "cpu"),
               "card": self.card}
        self.rows.append(row)
        print(json.dumps(row), flush=True)

    def wam_field(self):
        if self._wam is None:
            self._wam = cs.wam_desk_sdf(self.dev)
        return self._wam

    def main(self):
        B = env_int("BENCH_BATCH", cs.B_MAIN)
        seed = self.seed_or(0)
        inputs = cs.main_path_inputs(self.dev, B=B, seed=seed, sdf=self.wam_field())
        solve = cs.path_solver(inputs, inputs[3], fetch=True)
        run = cs.timed_main_path("main", solve, B=B, repeats=self.repeats)
        res, cc = run.res, run.cc
        conv = (res.converged & ~res.gave_up).numpy()
        free = (cc < 1e-4).numpy()
        best, median = spread(run.times)
        value = float((conv & free).sum()) / best
        base = self.baseline and self.baseline["wam"]["plans_per_sec"]
        lat = {b: cs.warm_latency_ms(solve, b, self.repeats) for b in (1, 32)}
        self.emit("main", {
            "metric": "wam7_converged_plans_per_sec_per_chip", "value": value,
            "unit": "plans/s", "vs_baseline": ratio(value, base),
            "baseline_plans_per_sec": base, "batch": B, "seed": seed,
            "converged_frac": float(conv.mean()), "gave_up_frac": float(res.gave_up.float().mean()),
            "collision_free_frac": float(free.mean()),
            "collision_free_among_converged": float(free[conv].mean()) if conv.any() else 0.0,
            "solve_time_s": best, "median_solve_time_s": median, "times_s": run.times,
            "latency_b1_ms": min(lat[1]), "latency_b1_median_ms": float(np.median(lat[1])),
            "latency_b1_times_ms": lat[1],
            "latency_b32_ms": min(lat[32]), "latency_b32_median_ms": float(np.median(lat[32])),
            "latency_b32_times_ms": lat[32],
            "warmup_s": run.warmup_s, "mean_iters": float(res.iterations.float().mean()),
            "median_err": float(np.median(res.error.numpy())), "launches": run.launches})
        cs.main_path_result("main", res, cc, B)

    def suite(self):
        batch = {"q512": env_int("SUITE_BATCH", cs.SUITE_BATCH["q512"])}
        for name, knob in (("PointRobot2D", "SUITE_B_POINT"), ("MobileBaseSE2", "SUITE_B_MOBILE"),
                           ("Arm3Limits2D", "SUITE_B_ARM3"), ("WAM7_3D", "SUITE_B_WAM"),
                           ("MultiWorld2D", "SUITE_B_MULTI")):
            batch[name] = env_int(knob, cs.SUITE_BATCH[name])
        seed_t = self.seed_or(1)
        oracles = cs.oracle_suite_quality()
        # the oracle's quality columns hold for its own 512-problem sets only
        on_oracle_set = batch["q512"] == 512
        host = self.baseline and self.baseline["configs"]
        for name, robot, setting, qset, tset, kwargs in cs.suite_configs(
                self.dev, self.wam_field(), batch, seed_t):
            m = cs.suite_measure(robot, setting, qset, tset, kwargs, self.repeats)
            (conv_q, free_q), (conv, gave, free, iters) = m["q512"], m["last"]
            best, median = spread(m["times"])
            value = float((conv & free).sum()) / best
            base = host and host[name]["plans_per_sec"]
            oracle = oracles[name] if on_oracle_set else None
            row = {
                "config": name, "plans_per_sec": value, "vs_baseline": ratio(value, base),
                "oracle_plans_per_sec": base, "batch": int(conv.shape[0]), "seed": seed_t,
                "solve_s": best, "median_solve_s": median, "times_s": m["times"],
                "warmup_s": m["warmup_s"], "converged_frac": float(conv.mean()),
                "gave_up_frac": float(gave.mean()), "collision_free_frac": float(free.mean()),
                "mean_iters": iters, "q512_batch": batch["q512"],
                "q512_converged_frac": float(conv_q.mean()),
                "q512_collision_free_frac": float(free_q.mean()), "q512_rescue_f64": True,
                "oracle_q512_converged_frac": oracle and oracle["converged"] / 512,
                "oracle_q512_collision_free_frac": oracle and oracle["collision_free"] / 512,
                "launches": m["launches"]}
            self.emit("suite", row)
            cs.suite_gates(name, row, self.dev.type == "cuda")

    def replan(self):
        import torch
        from gpmp2_tpu_torch.robots import generate_arm

        B, rounds = env_int("BENCH_BATCH", cs.B_FLEET), env_int("BENCH_ROUNDS", cs.FLEET_ROUNDS)
        seed = self.seed_or(0)
        robot = generate_arm("WAMArm", dtype=torch.float32, device=self.dev)
        fleet, one_round = cs.wam_fleet_sessions(self.dev, (robot, self.wam_field()), B, seed)
        t0 = time.perf_counter()
        fleet.update()
        one_round(0)
        warmup_s = time.perf_counter() - t0
        out, _, _, times, launches = cs.fleet_rounds(one_round, rounds)
        value = B * rounds / sum(times)
        self.emit("replan", {
            "metric": "wam7_session_updates_per_sec_per_chip", "value": value,
            "unit": "updates/s", "vs_target": value / 1000.0, "batch": B, "rounds": rounds,
            "warm_iter": cs.FLEET_WARM_ITER, "seed": seed,
            "round_ms": 1e3 * sum(times) / rounds,
            "median_round_ms": 1e3 * float(np.median(times)), "times_s": times,
            "warmup_s": warmup_s, "converged_frac": float(out.converged.float().mean()),
            "mean_iters": float(out.iterations.float().mean()), "launches": launches[-1]})

    def longhorizon(self):
        seed = self.seed_or(0)
        for row, _ in cs.lh_rows(self.dev, self.card, B=env_int("LH_BATCH", cs.LH_B),
                                 seed=seed, repeats=self.repeats,
                                 ns=env_ints("LH_NS", cs.LH_NS)):
            launches = {"btsolve": row.pop("k1_launches_per_solve")}
            self.emit("longhorizon", {**row, "seed": seed, "launches": launches})


def out_path(path):
    """`path` resolved, which must lie under the repository's build/."""
    build = os.path.join(REPO, "build")
    full = os.path.realpath(path)
    if os.path.commonpath([full, os.path.realpath(build)]) != os.path.realpath(build):
        raise SystemExit(f"bench_torch: --out must lie under {build}, not {path}")
    return full


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=CONFIGS + ("all",), default="main")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch versions on the CPU")
    ap.add_argument("--seed", type=int, default=None,
                    help="the draws' numpy seed (default: the JAX scripts')")
    ap.add_argument("--repeats", type=int, default=None,
                    help="timed repeats (default BENCH_REPEATS or 3)")
    ap.add_argument("--out", default=None, help="also write every row here, under build/")
    args = ap.parse_args(argv)
    out = None if args.out is None else out_path(args.out)

    import torch
    from gpmp2_tpu_torch.device import resolve_device

    dev = resolve_device("cpu" if args.cpu else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = None if args.cpu else cs.nvidia_smi_card()
    repeats = args.repeats if args.repeats is not None else env_int("BENCH_REPEATS", cs.REPEATS)
    bench = Bench(dev, card, args.seed, repeats)
    for config in CONFIGS if args.config == "all" else (args.config,):
        getattr(bench, config)()
    if out is not None:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as fh:
            json.dump({"card": card, "rows": bench.rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
