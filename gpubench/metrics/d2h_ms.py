"""Mean device-to-host transfer of the mesh a request, ms: ``LAST_STATS
["d2h"]``, or ``["tiles_d2h"]`` on a call routed to the tiles
(``engine.PROFILE`` fences the device before it)."""


def read(ctx):
    vals = [s["tiles_d2h"] if "tiles_d2h" in s else s["d2h"]
            for s in ctx["stats"] if "tiles_d2h" in s or "d2h" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
