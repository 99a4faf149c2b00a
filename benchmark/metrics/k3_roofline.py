"""K3 (ops/sdf_lookup.py, csrc/sdf_lookup.cu, kernel `sdf_lookup_kernel`):
the bound of its launches in the traced window over their device time,
in percent. A request launches K3 in every linearize of plan_batch, on
every collision state of every plan, and once in collision_cost, on the
support states alone; the traced window holds whole requests, so that
many launches (one a collision_cost span) take the support states'
bound and the rest the collision states'. Each bound counts the distinct
packed rows that the queries of the cell's first request read."""

from benchmark import roofline, trace

KERNEL = r"\bsdf_lookup_kernel\b"


def _bound(run, support):
    f = run.config["field"]
    pts = run.loop.first_queries(support)
    sizes = f["shape"] if len(f["shape"]) == 3 else f["shape"][::-1]
    rows = roofline.distinct_rows(pts, f["origin"], f["cell_size"], sizes)
    return roofline.k3_bound(pts.shape[0], len(sizes), rows)


def read(run):
    launches, seconds = trace.matching(run.ops, KERNEL)
    if not launches:
        return None
    end = run.traced_ns[1]
    checks = sum(1 for name, a, _ in run.spans if name == "collision_cost" and a < end)
    bound = (launches - checks) * _bound(run, False) + checks * _bound(run, True)
    return 100.0 * bound / (seconds * 1e3)
