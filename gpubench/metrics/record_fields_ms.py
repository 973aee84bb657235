"""Mean host time of kernel B1's field pre-pass a request, ms:
``LAST_STATS["record_fields"]`` (``eval_classify.record_fields``: the
fields of the gather-bearing subtrees recorded over the whole grid with
torch ops), requests outside the profiled stretch."""


def read(ctx):
    vals = [s["record_fields"] for s in ctx["stats"] if "record_fields" in s]
    return 1e3 * sum(vals) / len(vals) if vals else None
