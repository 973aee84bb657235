"""Mean host waits for the card a request: ``LAST_STATS["host_waits"]``,
the call's ``node.fetch`` transfers, requests outside the profiled
stretch."""


def read(ctx):
    vals = [s["host_waits"] for s in ctx["stats"] if "host_waits" in s]
    return sum(vals) / len(vals) if vals else None
