"""Mean latency of a request outside the profiled stretch, ms: the time a
mesh costs, in the cells whose host time spreads too widely between runs
for ``mesh_ms`` to stand end to end (read in the traced run, with
``engine.PROFILE`` on: one fence a call)."""


def read(ctx):
    lat = ctx.get("latencies") or []
    return 1e3 * sum(lat) / len(lat) if lat else None
