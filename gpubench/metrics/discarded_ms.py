"""Mean host time of the speculative dense pass a routed request
discards, ms: ``LAST_STATS["speculative"]`` (from the cull's dispatch
through the counts fetch to the routing decision) of the requests routed
to the tiles (``"auto_tiles"`` in their stats), outside the profiled
stretch."""


def read(ctx):
    vals = [s["speculative"] for s in ctx["stats"]
            if "auto_tiles" in s and "speculative" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
