"""Mean host wall of the bounds refinement a request, ms
(``LAST_STATS["bounds"]``, requests outside the profiled stretch)."""


def read(ctx):
    vals = [s["bounds"] for s in ctx["stats"] if "bounds" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
