"""Kernel B1's share of its roofline, %: the least time the card could
take for the dense grid's work (the configuration's frozen operations and
bytes a sample and a cell, on the grid the reference works out for each
profiled request) over B1's device time, summed over the stretch."""


def read(ctx):
    d = ctx["trace"]["durations"].get("B1") or []
    peaks, w = ctx["peaks"], ctx["config"]["work"]
    if not d or peaks is None or len(d) != len(ctx["work"]):
        return None
    least = 0.0
    for r in ctx["work"]:
        flops = w["flops_per_sample"] * r["samples"]
        nbytes = w["bytes_per_sample"] * r["samples"] + \
            w["bytes_per_cell"] * r["cells"]
        least += max(flops / peaks["f32_flops_per_s"],
                     nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least / sum(d)
