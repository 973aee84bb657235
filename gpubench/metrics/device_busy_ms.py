"""The device's busy time (the union of kernel, copy and set intervals)
a profiled request, ms."""


def read(ctx):
    t = ctx["trace"]
    if t["busy_s"] <= 0 or not ctx["requests"]:
        return None
    return 1e3 * t["busy_s"] / ctx["requests"]
