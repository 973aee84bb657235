"""Mean rounds of the bounds refinement whose values the CPU evaluated a
request: ``LAST_STATS["bounds_cpu_rounds"]`` (every round where the card's
probe cannot run, as for a gather-bearing expression, and each near-tie
fallback otherwise), requests outside the profiled stretch."""


def read(ctx):
    vals = [s["bounds_cpu_rounds"] for s in ctx["stats"]
            if "bounds_cpu_rounds" in s]
    return sum(vals) / len(vals) if vals else None
