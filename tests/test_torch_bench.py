"""The port's measuring entry points on the CPU: tools/oracle/suite_dump_torch.py
against tools/oracle/suite_dump.py, the main mode's endpoint sampler against
bench.py's, bench_torch.py's long-horizon mode run small, and the three
scripts' refusal without a CUDA device."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

DUMP_FILES = ("pointrobot2d.bin", "mobilebase_se2.bin", "arm3limits2d.bin", "wam7_probs.bin",
              "multiworld2d.bin")


def _env(**extra):
    """This process's environment without CUDA devices or JAX's x64 (the
    JAX scripts run in float32, as on their own machine), plus `extra`."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env.update(CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu", **extra)
    return env


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """suite_dump.py and suite_dump_torch.py --cpu at SUITE_BATCH = 16, run
    together, each into a directory of its own."""
    dirs = tmp_path_factory.mktemp("jax_dumps"), tmp_path_factory.mktemp("torch_dumps")
    scripts = (["tools/oracle/suite_dump.py", str(dirs[0])],
               ["tools/oracle/suite_dump_torch.py", str(dirs[1]), "--cpu"])
    procs = [subprocess.Popen([sys.executable, *args], cwd=REPO, env=_env(SUITE_BATCH="16"),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for args in scripts]
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, out + err
    return dirs


@pytest.mark.parametrize("name", DUMP_FILES)
def test_suite_dump_matches_jax(dumps, name):
    """The port's dump equals the JAX script's byte for byte: the header,
    the robot and problem arrays and the float32 SDF (both packages compute
    the EDT on the host in float64 and round it once)."""
    jax_bytes, torch_bytes = ((d / name).read_bytes() for d in dumps)
    if name != "wam7_probs.bin":
        end = jax_bytes.index(b"\nend\n") + 5
        assert torch_bytes[:end] == jax_bytes[:end]
    assert torch_bytes == jax_bytes


def test_main_endpoint_sampler_matches_bench_py():
    """main_path_endpoints at B = 64 (float32, CPU, the port's WAMDeskDataset
    field) draws bench.py:99-123's starts and goals, reproduced here with the
    JAX package on its own field."""
    import jax
    import jax.numpy as jnp
    from gpmp2_tpu.datasets import generate_3d_dataset as j_gen3d
    from gpmp2_tpu.datasets import sdf_from_occupancy as j_sdf
    from gpmp2_tpu.obstacle.factors import obstacle_factor_error
    from gpmp2_tpu.robots import generate_arm as j_arm
    from gpmp2_tpu_torch.robots import generate_arm

    B = 64
    robot = generate_arm("WAMArm", dtype=torch.float32, device="cpu")
    starts, goals = cs.main_path_endpoints(robot, cs.wam_desk_sdf(torch.device("cpu")), B)

    j_robot = j_arm("WAMArm", dtype=jnp.float32)
    ds = j_gen3d("WAMDeskDataset")
    j_field = j_sdf(ds.origin, ds.cell_size, ds.map, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    err = jax.jit(jax.vmap(lambda q: obstacle_factor_error(j_robot, j_field, q, 0.0).sum()))

    def sample_feasible(base, n):
        out = []
        while len(out) < n:
            cand = base + 0.05 * rng.normal(size=(2 * n, 7))
            ok = np.asarray(err(jnp.asarray(cand, jnp.float32))) < 1e-6
            out.extend(cand[ok][: n - len(out)])
        return np.stack(out)

    ref_starts = sample_feasible(cs.BASE_START, B).astype(np.float32)
    ref_goals = sample_feasible(cs.BASE_GOAL, B).astype(np.float32)
    np.testing.assert_array_equal(starts.numpy(), ref_starts)
    np.testing.assert_array_equal(goals.numpy(), ref_goals)


def _root_files():
    """The repository root's files with their sizes and modification times."""
    return {e.name: (e.stat().st_size, e.stat().st_mtime_ns)
            for e in os.scandir(REPO) if e.is_file()}


def test_bench_longhorizon_cpu_small():
    """bench_torch.py --cpu --config longhorizon at B = 8 and n = 65 and 257
    (P = 2 and 4; LH_NS): one row per (n, solver) with the stated keys,
    residuals below 1e-4, and no file written at the root (LONGHORIZON.json
    stays the TPU run's)."""
    before = _root_files()
    ns = (65, 257)
    out = subprocess.run([sys.executable, "bench_torch.py", "--cpu", "--config", "longhorizon"],
                         cwd=REPO, env=_env(LH_BATCH="8", LH_NS=",".join(map(str, ns))),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    want = [(n, s) for n in ns
            for s in ("K1", f"partitioned(P={max(2, min(64, n // 64))})")]
    assert [(r["n"], r["solver"]) for r in rows] == want
    for r in rows:
        assert {"mode", "metric", "n", "m", "B", "solver", "ms", "median_ms", "times_ms",
                "device_ms", "rel_residual", "seed", "launches", "device", "card"} <= set(r)
        assert (r["mode"], r["m"], r["B"], r["seed"], r["device"]) == ("longhorizon", 14, 8, 0,
                                                                        "cpu")
        assert r["card"] is None and r["device_ms"] is None
        assert len(r["times_ms"]) == 3 and r["ms"] == min(r["times_ms"])
        assert r["rel_residual"] < 1e-4
    assert _root_files() == before


@pytest.mark.parametrize("args", [["bench_torch.py"],
                                  ["tools/oracle/suite_dump_torch.py", "{tmp}"],
                                  ["tools/oracle/measure_host.py"]],
                         ids=["bench_torch", "suite_dump_torch", "measure_host"])
def test_scripts_refuse_without_cuda(args, tmp_path):
    """Without a CUDA device and without --cpu each script exits non-zero
    with the "no CUDA device" message, before writing anything."""
    args = [a.format(tmp=tmp_path / "dumps") for a in args]
    out = subprocess.run([sys.executable, *args], cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not (tmp_path / "dumps").exists()
