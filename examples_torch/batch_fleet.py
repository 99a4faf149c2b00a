"""Fleet planning: a batch of WAM problems split over a device mesh.

Port of examples/batch_fleet.py. B randomized WAM problems (FLEET_BATCH,
default 256) in an analytic ball world (48^3) shard over the 'dp' dim of a
mesh (`parallel.make_mesh`); each rank plans its lanes with `plan_batch`
to per-problem convergence, and `fleet_stats` reduces the fleet's
statistics with one all_reduce.

Ranks: PyTorch runs one process per device, so `main` starts one rank per
visible card with torch.multiprocessing.spawn (NCCL); the ranks meet on a
FileStore in a temporary directory. With --cpu it starts 2 gloo ranks on
the CPU instead: the counterpart of the JAX example's 8 virtual CPU
devices, with more than one rank and still light enough for a test run.

Run: python examples_torch/batch_fleet.py [--cpu]
"""

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpmp2_tpu_torch.obstacle.sdf import SignedDistanceField  # noqa: E402
from gpmp2_tpu_torch.parallel import fleet_stats, make_mesh, shard_problems  # noqa: E402
from gpmp2_tpu_torch.planner import TrajOptimizerSetting, make_problem, plan_batch  # noqa: E402
from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting  # noqa: E402
from gpmp2_tpu_torch.planner.traj_utils import init_traj_straight_line  # noqa: E402
from gpmp2_tpu_torch.robots import generate_arm  # noqa: E402

CPU_RANKS = 2


def fleet_problems(B, dev):
    """The fleet on `dev` in float32: (problems, straight-line init, LM
    parameters). Every rank builds the same batch from numpy seed 0."""
    robot = generate_arm("WAMArm", device=dev)

    # analytic ball-world SDF (fast to build for the demo)
    grid, cell = 48, 2.4 / 47
    origin = np.array([-1.2, -1.2, -0.4])
    ax = origin[:, None] + cell * np.arange(grid)[None, :]
    Z, Y, X = np.meshgrid(ax[2], ax[1], ax[0], indexing="ij")
    dist_ = np.sqrt((X - 0.45) ** 2 + Y**2 + (Z - 0.6) ** 2) - 0.2
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    sdf = SignedDistanceField(origin=f(origin), cell_size=f(cell), data=f(dist_))

    setting = TrajOptimizerSetting(
        dof=7, total_step=10, total_time=2.0, epsilon=0.2, cost_sigma=0.02,
        obs_check_inter=5, opt_type="lm", max_iter=30, rel_thresh=1e-2, Qc=np.eye(7))

    rng = np.random.default_rng(0)
    bs = np.array([-0.8, -1.70, 1.64, 1.29, 1.1, -0.106, 2.2])
    bg = np.array([-0.0, 0.94, 0.0, 1.6, 0.0, -0.919, 1.55])
    starts = f(bs + 0.05 * rng.normal(size=(B, 7)))
    goals = f(bg + 0.05 * rng.normal(size=(B, 7)))
    zeros = torch.zeros_like(starts)
    probs = make_problem(robot, sdf, starts, zeros, goals, zeros, setting)
    init = init_traj_straight_line(probs.space, starts, goals, 10, 2.0)
    return probs, init, optimizer_params_from_setting(setting)


def plan_fleet(mesh, B, dev):
    """Shard the fleet over the mesh's 'dp' dim, plan this rank's lanes twice
    (the first call builds the kernels on a card) and reduce the fleet's
    statistics. Returns (result of this rank's lanes, fleet_stats, seconds
    of the first and the repeated solve)."""
    probs, init, params = fleet_problems(B, dev)
    probs, init = shard_problems(mesh, probs, init)

    def solve():
        dist.barrier()
        t0 = time.perf_counter()
        res = plan_batch(probs, init, params)
        stats = fleet_stats(mesh, res)  # the all_reduce waits for every rank
        stats = {k: float(v) for k, v in stats.items()}
        return res, stats, time.perf_counter() - t0

    _, _, t_first = solve()
    res, stats, t_repeat = solve()
    return res, stats, t_first, t_repeat


def run_rank(rank, world, store, B, cpu):
    """One rank of the fleet; rank 0 prints."""
    if cpu:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group("gloo" if cpu else "nccl", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(world, axis_names=("dp",), device=dev)
        if rank == 0:
            print(f"devices: {world}; mesh: {mesh}", flush=True)
        res, stats, t_first, t_repeat = plan_fleet(mesh, B, dev)
        # the median needs every lane's error: B floats, gathered once
        errs = [torch.empty_like(res.error) for _ in range(world)]
        dist.all_gather(errs, res.error)
        if rank == 0:
            err = torch.cat(errs).cpu().numpy()
            print(f"{B} problems | compile+1st {t_first:.1f}s | repeat {t_repeat * 1e3:.0f}ms "
                  f"| {stats['converged'] / t_repeat:.0f} plans/s", flush=True)
            print(f"converged {stats['converged'] / B * 100:.1f}% | median err "
                  f"{np.median(err):.2f} | result sharded over {world} devices", flush=True)
            print("result", json.dumps({
                "error": stats["mean_error"], "iterations": stats["mean_iters"],
                "n": stats["n"], "converged": stats["converged"], "gave_up": stats["gave_up"],
                "ranks": world, "repeat_ms": t_repeat * 1e3}), flush=True)
    finally:
        dist.destroy_process_group()


def main():
    cpu = "--cpu" in sys.argv
    B = int(os.environ.get("FLEET_BATCH", "256"))
    world = CPU_RANKS if cpu else torch.cuda.device_count()
    if world == 0:
        raise RuntimeError("batch_fleet: no CUDA device; pass --cpu to run on the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run_rank, args=(world, os.path.join(tmp, "store"), B, cpu), nprocs=world)


if __name__ == "__main__":
    main()
