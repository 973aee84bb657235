"""Mean host wall of the probe cull a request, ms: ``LAST_STATS
["skip_dispatch"]`` plus ``["skip_mask"]`` where the call has it."""


def read(ctx):
    vals = [s.get("skip_dispatch", 0.0) + s.get("skip_mask", 0.0)
            for s in ctx["stats"] if "skip_dispatch" in s or "skip_mask" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
