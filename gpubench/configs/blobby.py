"""The blobby configuration: fogleman/sdf ``examples/blobby.py``.

``build(api, v)`` writes the upstream script's expression against the
public fogleman/sdf API, with each radius, offset and smoothing radius
taken from ``v`` (see ``knurling.py``).
"""


def build(api, v):
    s = api.sphere(v["end_radius"])
    s = s.translate(api.Z * -v["end_offset"]) | s.translate(
        api.Z * v["end_offset"])
    s = s.union(api.capsule(api.Z * -v["bar_half_length"],
                            api.Z * v["bar_half_length"], v["bar_radius"]),
                k=v["bar_k"])
    return api.sphere(v["core_radius"]).union(
        s.orient(api.X), s.orient(api.Y), s.orient(api.Z), k=v["core_k"])
