"""Mean host time of the eval kernels' source and library lookup a
request, ms: ``LAST_STATS["kernel_source"]``, the call's ``kernel_source``
spans summed (each launch of B1, B6 or B7 generates its kernel's source,
finds the library built from it and types its entry), requests outside
the profiled stretch."""


def read(ctx):
    vals = [s["kernel_source"] for s in ctx["stats"] if "kernel_source" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
