"""The knurling configuration: fogleman/sdf ``examples/knurling.py``.

``build(api, v)`` writes the upstream script's expression against the
public fogleman/sdf API, with each length and smoothing radius taken from
``v`` (the values of ``knurling.json``'s ``params``, scaled by a request's
draw).  ``api`` is the program's package for a timed request and the
benchmark's frozen reference DSL for the check.
"""


def build(api, v):
    f = api.rounded_cylinder(v["body_radius"], v["body_round"],
                             v["body_height"])
    x = api.box((v["knurl_width"], v["knurl_width"], v["knurl_length"]))
    x = x.rotate(api.pi / 4)
    x = x.circular_array(24, v["knurl_offset"])
    x = x.twist(0.75) | x.twist(-0.75)
    f -= x.k(v["knurl_k"])
    f -= api.cylinder(v["bore_radius"]).k(v["bore_k"])
    c = api.cylinder(v["vent_radius"]).orient(api.X)
    f -= c.translate(api.Z * -v["vent_offset"]).k(v["vent_k"])
    f -= c.translate(api.Z * v["vent_offset"]).k(v["vent_k"])
    return f
