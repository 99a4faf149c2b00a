"""K2 (ops/fk_arm.py, csrc/fk_arm.cu, kernel `fk_kernel`): its bound at
the cell's shape (B plans' collision states, dof, spheres) times its
launches in the traced window, over their device time, in percent."""

from benchmark import roofline, trace

KERNEL = r"\bfk_kernel\b"


def read(run):
    launches, seconds = trace.matching(run.ops, KERNEL)
    if not launches:
        return None
    s = run.loop.shapes()
    bound = roofline.k2_bound(s["B"] * s["confs"], s["d"], s["S"])
    return 100.0 * bound * launches / (seconds * 1e3)
