"""A closed loop of batch plans.

Traffic parameters: `batch` (B, problems a request) and `pool` (distinct
requests drawn in set-up; the window cycles through them). Each request
builds its problems with make_problem on the field packed once in
set-up, plans them from the straight line with plan_batch, takes their
collision costs, and copies the trajectory and the result columns to the
host; its latency runs from the start of make_problem to the end of the
copy. A plan counts as good when it converged, did not give up and its
collision cost is below 1e-4 (bench.py's protocol).

After the window the reference judges a sample of the window's plans,
drawn from the seed (the cell file's `sample`, plus the plan that took
the most iterations): see reference/judge.py.
"""

import importlib

import numpy as np

from ..reference import datasets, field as rfield, judge

FREE_BELOW = judge.FREE_BELOW


class Loop:
    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.B = run.traffic["batch"]
        self.pool = run.traffic["pool"]

    # ---- set-up ---------------------------------------------------------

    def setup(self):
        import torch

        run, cfg, dev = self.run, self.cfg, self.run.device
        f32 = torch.float32
        with run.part("imports"):
            from gpmp2_tpu_torch import planner
            from gpmp2_tpu_torch.datasets import planar_sdf_from_occupancy, sdf_from_occupancy
            from gpmp2_tpu_torch.planner.batch import optimizer_params_from_setting
        self.planner = planner
        fcfg = cfg["field"]
        with run.part("occupancy"):
            self.occ = datasets.occupancy(fcfg)
        with run.part("reference field"):
            self.ref = judge.Problem(cfg, rfield.Field(
                rfield.signed_distance(torch.as_tensor(self.occ > 0.75, device=dev),
                                       fcfg["cell_size"]), fcfg["origin"], fcfg["cell_size"]),
                dev)
        with run.part("draws"):
            from .. import draws
            s, g = draws.endpoints(run.seed, self.pool * self.B, cfg["draw"], self.ref)
            d = s.shape[1]
            self.starts_np = s.reshape(self.pool, self.B, d)
            self.goals_np = g.reshape(self.pool, self.B, d)
        self.ref.field.data = self.ref.field.data.cpu()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        with run.part("field"):
            if len(fcfg["shape"]) == 3:
                sdf = sdf_from_occupancy(fcfg["origin"], fcfg["cell_size"], self.occ,
                                         dtype=f32, device=dev)
            else:
                sdf = planar_sdf_from_occupancy(fcfg["origin"], fcfg["cell_size"], self.occ,
                                                dtype=f32, device=dev)
        kind = cfg["robot"]["kind"]
        self.robot = importlib.import_module(f"benchmark.robots.{kind}").build(
            cfg["robot"], f32, dev)
        st = dict(cfg["setting"])
        st["Qc"] = np.asarray(st["Qc"], np.float64)
        self.setting = planner.TrajOptimizerSetting(**st)
        self.params = optimizer_params_from_setting(self.setting)
        self.kw = dict(cfg.get("problem", {}))
        self.starts = torch.as_tensor(self.starts_np, dtype=f32, device=dev)
        self.goals = torch.as_tensor(self.goals_np, dtype=f32, device=dev)
        self.zeros = torch.zeros_like(self.starts[0])
        with run.part("pack"):
            one = slice(0, 1)
            self.sdf = planner.make_problem(self.robot, sdf, self.starts[0, one], self.zeros[one],
                                            self.goals[0, one], self.zeros[one], self.setting,
                                            **self.kw).sdf

    def warm(self):
        for k in range(min(2, self.pool)):
            self.call(k)

    # ---- the window -----------------------------------------------------

    def call(self, k, spans=None):
        import contextlib

        p, st = self.planner, self.setting
        span = spans or (lambda name: contextlib.nullcontext())
        with span("make_problem"):
            probs = p.make_problem(self.robot, self.sdf, self.starts[k], self.zeros,
                                   self.goals[k], self.zeros, st, **self.kw)
        with span("init"):
            init = p.init_traj_straight_line(probs.space, probs.start_pose, probs.end_pose,
                                             st.total_step, st.total_time)
        with span("plan_batch"):
            res = p.plan_batch(probs, init, self.params)
        with span("collision_cost"):
            cc = p.collision_cost(probs, res.traj.pose)
        with span("host_copy"):
            out = {"k": k, "pose": res.traj.pose.cpu().numpy(), "vel": res.traj.vel.cpu().numpy(),
                   "error": res.error.cpu().numpy(), "iterations": res.iterations.cpu().numpy(),
                   "converged": res.converged.cpu().numpy(), "gave_up": res.gave_up.cpu().numpy(),
                   "cc": cc.cpu().numpy()}
        return out

    def request(self, i):
        import time

        t0 = time.perf_counter()
        out = self.call(i % self.pool, self.run.span)
        out["latency_s"] = time.perf_counter() - t0
        out["good"] = int((out["converged"] & ~out["gave_up"] & (out["cc"] < FREE_BELOW)).sum())
        return out

    def attempted(self):
        return sum(len(r["error"]) for r in self.run.requests)

    def failed(self):
        return self.attempted() - sum(r["good"] for r in self.run.requests)

    # ---- what metric readers read ---------------------------------------

    def shapes(self):
        """B, support states n, dof d, spheres S, collision states a plan."""
        st = self.cfg["setting"]
        n = st["total_step"] + 1
        return {"B": self.B, "n": n, "d": st["dof"], "S": len(self.cfg["robot"]["spheres"]),
                "confs": n + (n - 1) * st["obs_check_inter"], "dim": len(self.cfg["field"]["shape"])}

    def first_problems(self):
        """The port's problems and straight-line init of the pool's first
        request, as the window builds them."""
        p, st = self.planner, self.setting
        probs = p.make_problem(self.robot, self.sdf, self.starts[0], self.zeros, self.goals[0],
                               self.zeros, st, **self.kw)
        init = p.init_traj_straight_line(probs.space, probs.start_pose, probs.end_pose,
                                         st.total_step, st.total_time)
        return probs, init

    def first_queries(self, support=False):
        """The sphere centres (N, 3) of the first linearize of the pool's
        first request (its straight line's collision states), or with
        `support` of its support states alone (what collision_cost looks
        up), from the reference's kinematics."""
        import torch

        r = self.ref
        dev = self.run.device
        s = torch.as_tensor(self.starts_np[0], dtype=torch.float64, device=dev)
        g = torch.as_tensor(self.goals_np[0], dtype=torch.float64, device=dev)
        pose, vel = r.straight_line(s, g)
        confs = pose
        if not support:
            inner = r.kind.interpolate(r.lam, r.psi, pose[:, :-1], vel[:, :-1], pose[:, 1:],
                                       vel[:, 1:])
            confs = torch.cat([pose, inner.reshape(pose.shape[0], -1, pose.shape[-1])], 1)
        return r.model.sphere_centers(confs).reshape(-1, 3)

    # ---- the check --------------------------------------------------------

    def release(self):
        """Free the port's state before the reference runs."""
        import torch

        for name in ("sdf", "robot", "starts", "goals", "zeros"):
            setattr(self, name, None)
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        """(request, lane) pairs of the judged sample, drawn from the seed:
        `sample` of the window's plans and the one with most iterations."""
        reqs = self.run.requests
        sizes = np.array([len(r["error"]) for r in reqs])
        total = int(sizes.sum())
        rng = np.random.default_rng([self.run.seed, 1])
        flat = set(rng.choice(total, size=min(self.run.check["sample"], total),
                              replace=False).tolist())
        iters = np.concatenate([r["iterations"] for r in reqs])
        flat.add(int(np.argmax(iters)))
        starts = np.concatenate([[0], np.cumsum(sizes)])
        out = []
        for f in sorted(flat):
            q = int(np.searchsorted(starts, f, side="right") - 1)
            out.append((q, f - int(starts[q])))
        return out

    def judge(self, control=None):
        import torch

        dev = self.run.device
        self.ref.field.data = self.ref.field.data.to(dev)
        picks = self.sample()
        reqs = self.run.requests
        col = lambda key: np.stack([reqs[q][key][b] for q, b in picks])  # noqa: E731
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        start = t(np.stack([self.starts_np[reqs[q]["k"], b] for q, b in picks]))
        goal = t(np.stack([self.goals_np[reqs[q]["k"], b] for q, b in picks]))
        pose, vel = t(col("pose")), t(col("vel"))
        cost, cc, progress = self.ref.judge(pose, vel, start, goal)
        port = {k: col(k) for k in ("error", "converged", "gave_up")}
        if control == "reference_bf16":
            low = judge.Problem(self.cfg, self.ref.field, dev, dtype=torch.bfloat16)
            lp, lv, ls, lg = (x.to(torch.bfloat16) for x in (pose, vel, start, goal))
            port["error"] = low.cost(lp, lv, ls, lg).double().cpu().numpy()
        return judge.compare(cost, cc, progress, port)
