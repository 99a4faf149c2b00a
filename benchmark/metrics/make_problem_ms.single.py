"""Mean of the benchmark's own host span around make_problem over the
window's requests (host clock)."""


def read(run):
    spans = [(b - a) / 1e6 for name, a, b in run.spans if name == "make_problem"]
    return sum(spans) / len(spans) if spans else None
