"""Kernel B6's share of its roofline, %: the least time the card could
take for the kept tiles' work (the configuration's frozen operations and
bytes; the samples and cells that the tiles the reference's own cull
keeps cover together, a sample shared by two tiles counted once) over
B6's device time, summed over the routed requests of the stretch."""


def read(ctx):
    d = ctx["trace"]["durations"].get("B6") or []
    routed = [r for r in ctx["work"] if r["routed"]]
    peaks, w = ctx["peaks"], ctx["config"]["work"]
    if not d or peaks is None or len(d) != len(routed):
        return None
    least = 0.0
    for r in routed:
        samples, cells = r["tile_samples"], r["tile_cells"]
        flops = w["flops_per_sample"] * samples
        nbytes = w["bytes_per_sample"] * samples + w["bytes_per_cell"] * cells
        least += max(flops / peaks["f32_flops_per_s"],
                     nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least / sum(d)
