"""Mean host decode of the fetched mesh a request, ms: ``LAST_STATS
["decode"]``, or ``["tiles_decode"]`` on a call routed to the tiles
(``sparse.PROFILE``)."""


def read(ctx):
    vals = [s["tiles_decode"] if "tiles_decode" in s else s["decode"]
            for s in ctx["stats"] if "tiles_decode" in s or "decode" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
