"""K1 (ops/btsolve.py, csrc/btsolve.cu, kernel `bt_kernel`): its bound at
the cell's shape (B systems of n blocks of 2 dof) times its launches in
the traced window, over their device time, in percent."""

from benchmark import roofline, trace

KERNEL = r"\bbt_kernel\b"


def read(run):
    launches, seconds = trace.matching(run.ops, KERNEL)
    if not launches:
        return None
    s = run.loop.shapes()
    return 100.0 * roofline.k1_bound(s["B"], s["n"], 2 * s["d"]) * launches / (seconds * 1e3)
