"""Mean host time of the expression fingerprints a request, ms:
``LAST_STATS["fingerprint"]``, the call's ``fingerprint`` spans summed
(every memo key, and the tiles' hash of the cull mask), requests outside
the profiled stretch."""


def read(ctx):
    vals = [s["fingerprint"] for s in ctx["stats"] if "fingerprint" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
