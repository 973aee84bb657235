"""2D primitives, positioning ops and 2D -> 3D lifts (counterpart of
``sdf_tpu.ops.shapes2``).

Every constructor returns an ``SDF2`` node (``extrude``, ``extrude_to``
and ``revolve`` an ``SDF3``); construction-time math runs in float64 numpy
exactly as in the JAX package, evaluation math is torch on ``Points`` and
keeps the JAX package's operation order term for term.  Constants inside
an eval function are Python floats, so they enter the generated kernel
body as literals and round to the field dtype like a weak JAX literal.

``polygon`` loops over its edges in Python, one set of tensor ops an edge
in the reference's order; the loop has no statement form in the generated
kernel body, so the node is gather-marked (``core.hybrid``) and its field
is recorded ahead with torch ops.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import hybrid
from ..core.node import SDF2, Points, as_param, op2, op23, sdf2
from . import csg, easing as ease
from . import vecmath as vm
from .vecmath import _length, _max, _mdot, _min, _normalize, _pmax, _vec, clip

ORIGIN = np.array((0, 0))

X = np.array((1, 0))
Y = np.array((0, 1))

UP = Y


# Primitives


@sdf2
def circle(radius=1, center=ORIGIN):
    params = {"radius": as_param(radius), "center": as_param(center)}

    def fn(q, p):
        return _length(p - q["center"]) - q["radius"]

    return fn, params


@sdf2
def line(normal=UP, point=ORIGIN):
    params = {
        "normal": as_param(_normalize(np.asarray(normal, dtype=np.float64))),
        "point": as_param(point),
    }

    def fn(q, p):
        return _mdot(q["point"] - p, q["normal"])

    return fn, params


@sdf2
def slab(x0=None, y0=None, x1=None, y1=None, k=None):
    fs = []
    if x0 is not None:
        fs.append(line(X, (x0, 0)))
    if x1 is not None:
        fs.append(line(-X, (x1, 0)))
    if y0 is not None:
        fs.append(line(Y, (0, y0)))
    if y1 is not None:
        fs.append(line(-Y, (0, y1)))
    return intersection(*fs, k=k)


@sdf2
def rectangle(size=1, center=ORIGIN, a=None, b=None):
    if a is not None and b is not None:
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        size = b - a
        center = a + size / 2
        return rectangle(size, center)
    params = {"size": as_param(size), "center": as_param(center)}

    def fn(q, p):
        d = abs(p - q["center"]) - q["size"] / 2
        return _length(_pmax(d, 0)) + _min(d.hmax(), 0)

    return fn, params


@sdf2
def rounded_rectangle(size, radius, center=ORIGIN):
    try:
        r0, r1, r2, r3 = radius
    except TypeError:
        r0 = r1 = r2 = r3 = radius
    params = {
        "size": as_param(size),
        "r": as_param((r0, r1, r2, r3)),
        "center": as_param(center),
    }

    def fn(q, p):
        x, y = p.c
        r = q["r"]
        # Per-quadrant corner radius.
        rq = torch.where(
            x > 0,
            torch.where(y > 0, r[0], r[1]),
            torch.where(y <= 0, r[2], r[3]),
        )
        d = abs(p) - q["size"] / 2 + rq
        return _min(_max(d.c[0], d.c[1]), 0) + _length(_pmax(d, 0)) - rq

    return fn, params


@sdf2
def equilateral_triangle():
    def fn(q, p):
        k = 3**0.5
        p = _vec(vm._abs(p.c[0]) - 1, p.c[1] + 1 / k)
        w = p.c[0] + k * p.c[1] > 0
        vx = (p.c[0] - k * p.c[1]) / 2
        vy = (-k * p.c[0] - p.c[1]) / 2
        p = _vec(torch.where(w, vx, p.c[0]), torch.where(w, vy, p.c[1]))
        p = _vec(p.c[0] - clip(p.c[0], -2, 0), p.c[1])
        return -_length(p) * torch.sign(p.c[1])

    return fn, {}


@sdf2
def hexagon(r):
    params = {"r": as_param(float(r) * 3**0.5 / 2)}
    k0, k1, k2 = (float(v) for v in (3**0.5 / -2, 0.5, np.tan(np.pi / 6)))

    def fn(q, p):
        r_ = q["r"]
        p = abs(p)
        m = _min(k0 * p.c[0] + k1 * p.c[1], 0)
        p = _vec(p.c[0] - 2 * k0 * m, p.c[1] - 2 * k1 * m)
        p = _vec(p.c[0] - clip(p.c[0], -k2 * r_, k2 * r_), p.c[1] - r_)
        return _length(p) * torch.sign(p.c[1])

    return fn, params


@sdf2
def rounded_x(w, r):
    params = {"w": as_param(w), "r": as_param(r)}

    def fn(q, p):
        p = abs(p)
        d = _min(p.c[0] + p.c[1], q["w"]) * 0.5
        # Subtract the per-point field from each component explicitly (see
        # Points._coerce on N == dim).
        return _length(_vec(p.c[0] - d, p.c[1] - d)) - q["r"]

    return fn, params


@sdf2
def polygon(points):
    # One (n, 2) parameter leaf, walked edge by edge in the reference's
    # order (its rolled fori_loop): float64 agrees bit for bit.
    params = {"points": as_param(np.asarray(points, dtype=np.float64))}

    @hybrid.mark_gather  # a loop over edges: no statement form in the body
    def fn(q, p):
        pts = q["points"]  # (n, 2)
        n = pts.shape[0]
        x, y = p.c
        shape = torch.broadcast_shapes(x.shape, y.shape)
        d0x = x - pts[0, 0]
        d0y = y - pts[0, 1]
        d = (d0x * d0x + d0y * d0y).broadcast_to(shape)
        s = torch.ones(shape, dtype=d.dtype, device=d.device)
        # Edge i runs from vertex i to vertex i - 1 (vj): its components
        # and the previous vertex, for all edges at once (elementwise, so
        # each value is the one the loop would compute).
        vj = torch.roll(pts, 1, dims=0)
        e = vj - pts
        for i in range(n):
            vix, viy = pts[i, 0], pts[i, 1]
            ex, ey = e[i, 0], e[i, 1]
            wx, wy = x - vix, y - viy
            t = clip((wx * ex + wy * ey) / (ex * ex + ey * ey), 0, 1)
            bx, by = wx - ex * t, wy - ey * t
            d = _min(d, bx * bx + by * by)
            c1 = y >= viy
            c2 = y < vj[i, 1]
            c3 = ex * wy > ey * wx
            s = torch.where((c1 & c2 & c3) | (~c1 & ~c2 & ~c3), -s, s)
        return s * vm.sqrt(d)

    return fn, params


@sdf2
def vesica(r, d):
    params = {"r": as_param(r), "d": as_param(d)}

    def fn(q, p):
        r_, d_ = q["r"], q["d"]
        p = abs(p)
        b = vm.sqrt(r_ * r_ - d_ * d_)
        return torch.where(
            (p.c[1] - b) * d_ > p.c[0] * b,
            _length(_vec(p.c[0], p.c[1] - b)),
            _length(_vec(p.c[0] + d_, p.c[1])) - r_,
        )

    return fn, params


# Positioning


@op2
def translate(other, offset):
    params = {"other": other, "offset": as_param(offset)}

    def fn(q, p):
        return q["other"](p - q["offset"])

    return fn, params


@op2
def scale(other, factor):
    try:
        x, y = factor
    except TypeError:
        x = y = factor
    params = {"other": other, "s": as_param((x, y)), "m": as_param(min(x, y))}

    def fn(q, p):
        return q["other"](p / q["s"]) * q["m"]

    return fn, params


@op2
def rotate(other, angle):
    s = np.sin(angle)
    c = np.cos(angle)
    matrix = np.array([[c, -s], [s, c]]).T
    params = {"other": other, "matrix": as_param(matrix)}

    def fn(q, p):
        return q["other"](_mdot(p, q["matrix"]))

    return fn, params


@op2
def circular_array(other, count):
    # A true k-way union of rotated copies in 2D, unlike the 3D op that
    # evaluates its child twice.
    angles = [i / count * 2 * np.pi for i in range(count)]
    return union(*[other.rotate(a) for a in angles])


# Alterations


@op2
def elongate(other, size):
    params = {"other": other, "size": as_param(size)}

    def fn(q, p):
        d = abs(p) - q["size"]
        x, y = d.c
        w = _min(_max(x, y), 0)
        return q["other"](_pmax(d, 0)) + w

    return fn, params


# 2D => 3D Operations


@op23
def extrude(other, h):
    params = {"other": other, "h": as_param(h)}

    def fn(q, p):
        d = q["other"](p[:, :2])
        w = _vec(d, vm._abs(p.c[2]) - q["h"] / 2)
        return _min(_max(w.c[0], w.c[1]), 0) + _length(_pmax(w, 0))

    return fn, params


@op23
def extrude_to(a, b, h, e=ease.linear):
    params = {"a": a, "b": b, "h": as_param(h)}

    def fn(q, p):
        d1 = q["a"](p[:, :2])
        d2 = q["b"](p[:, :2])
        t = e(clip(p.c[2] / q["h"], -0.5, 0.5) + 0.5)
        d = d1 + (d2 - d1) * t
        w = _vec(d, vm._abs(p.c[2]) - q["h"] / 2)
        return _min(_max(w.c[0], w.c[1]), 0) + _length(_pmax(w, 0))

    return fn, params


@op23
def revolve(other, offset=0):
    params = {"other": other, "offset": as_param(offset)}

    def fn(q, p):
        w = _vec(_length(p[:, :2]) - q["offset"], p.c[2])
        return q["other"](w)

    return fn, params


# Common n-D CSG ops registered for SDF2

union = op2(csg.union)
difference = op2(csg.difference)
intersection = op2(csg.intersection)
blend = op2(csg.blend)
negate = op2(csg.negate)
dilate = op2(csg.dilate)
erode = op2(csg.erode)
shell = op2(csg.shell)
repeat = op2(csg.repeat)

__all__ = [
    "ORIGIN", "X", "Y", "UP", "SDF2", "Points",
    "circle", "line", "slab", "rectangle", "rounded_rectangle",
    "equilateral_triangle", "hexagon", "rounded_x", "polygon", "vesica",
    "translate", "scale", "rotate", "circular_array", "elongate", "extrude",
    "extrude_to", "revolve", "union", "difference", "intersection", "blend",
    "negate", "dilate", "erode", "shell", "repeat",
]
