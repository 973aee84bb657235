"""Mean host wait for the card a request, ms: ``LAST_STATS["wait"]``, the
call's ``wait`` spans summed (the part of each ``node.fetch`` before its
copy, and the fences of ``engine.PROFILE``/``sparse.PROFILE``), requests
outside the profiled stretch.  The host can wait only while the card works
or copies: the profiler-free counterpart of the card's busy time."""


def read(ctx):
    vals = [s["wait"] for s in ctx["stats"] if "wait" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
