"""Reduction of a ``torch.profiler`` trace of a stretch of requests to the
numbers the per-layer readers take: the device's busy time (the union of
its kernel, copy and set intervals), each named kernel's durations and
launches, the operations that took most time, and the idle gaps named by
the host range that was open (``sdf_torch.<phase>`` from the program,
``gpubench.<step>`` from the harness)."""

from __future__ import annotations

import torch

RANGES = ("sdf_torch.", "gpubench.")
STRETCH = "gpubench.stretch"


def _short(name):
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:96]


def events(prof):
    """``(name, on the device, start ns, end ns)`` of every event of a
    stopped ``torch.profiler.profile``, read from its raw results (the
    parsed ``prof.events()`` takes minutes for the host's small calls)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()]


def reduce(events, kernels):
    """``events``: from ``events(prof)``; ``kernels``: ``{label: name
    fragment}``.  Returns a dict with ``busy_s``, ``window_s``,
    ``launches`` and ``durations`` by label, ``device_ops`` and
    ``idle_gaps`` (lists of ``[name, seconds]``, longest first)."""
    dev, host = [], []
    stretch = None
    for name, on_device, a, b in events:
        if on_device:
            if not name.startswith(RANGES):
                dev.append((a, b, name))
        elif name.startswith(RANGES):
            host.append((a, b, name))
            if name == STRETCH:
                stretch = (a, b)
    if stretch is None:
        raise RuntimeError("the profile holds no %s range" % STRETCH)
    s0, s1 = stretch
    dev = [d for d in dev if d[1] > s0 and d[0] < s1]
    dev.sort()

    launches = {k: 0 for k in kernels}
    durations = {k: [] for k in kernels}
    ops = {}
    for a, b, name in dev:
        key = _short(name)
        ops[key] = ops.get(key, 0.0) + (b - a) * 1e-9
        for label, frag in kernels.items():
            if frag in name:
                launches[label] += 1
                durations[label].append((b - a) * 1e-9)

    busy = 0.0
    gaps = []
    edge = s0
    for a, b, _ in dev:
        a, b = max(a, s0), min(b, s1)
        if a > edge:
            gaps.append((edge, a))
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    if s1 > edge:
        gaps.append((edge, s1))

    # Each piece of a gap goes to the innermost host range open over it
    # (the one that opened last).
    idle = {}
    host = sorted(h for h in host if h[2] != STRETCH)
    for a, b in gaps:
        inside = [h for h in host if h[0] < b and h[1] > a]
        cuts = sorted({a, b} | {t for h in inside for t in h[:2]
                                if a < t < b})
        for c0, c1 in zip(cuts, cuts[1:]):
            mid = 0.5 * (c0 + c1)
            open_ = [h for h in inside if h[0] <= mid <= h[1]]
            name = max(open_)[2] if open_ else "outside_ranges"
            idle[name] = idle.get(name, 0.0) + (c1 - c0) * 1e-9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][:10]

    return {"busy_s": busy * 1e-9, "window_s": (s1 - s0) * 1e-9,
            "launches": launches, "durations": durations,
            "device_ops": top(ops), "idle_gaps": top(idle)}
