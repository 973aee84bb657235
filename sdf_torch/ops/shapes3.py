"""3D primitives, positioning ops and deformations (counterpart of
``sdf_tpu.ops.shapes3``).

Every constructor returns an ``SDF3`` node; construction-time math runs
in float64 numpy exactly as in the JAX package, evaluation math is torch
on ``Points`` and keeps the JAX package's operation order term for term.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.node import SDF3, Points, as_param, op3, op32, sdf3
from . import csg, easing as ease
from . import vecmath as vm
from .vecmath import (
    _div_const,
    _dot,
    _length,
    _max,
    _mdot,
    _min,
    _normalize,
    _pmax,
    _vec,
    _vmul,
    clip,
)

ORIGIN = np.array((0, 0, 0))

X = np.array((1, 0, 0))
Y = np.array((0, 1, 0))
Z = np.array((0, 0, 1))

UP = Z


def _perpendicular(v):
    if v[1] == 0 and v[2] == 0:
        if v[0] == 0:
            raise ValueError("zero vector")
        return np.cross(v, [0, 1, 0])
    return np.cross(v, [1, 0, 0])


# Primitives


@sdf3
def sphere(radius=1, center=ORIGIN):
    params = {"radius": as_param(radius), "center": as_param(center)}

    def fn(q, p):
        return _length(p - q["center"]) - q["radius"]

    return fn, params


@sdf3
def plane(normal=UP, point=ORIGIN):
    params = {"normal": as_param(_normalize(np.asarray(normal, dtype=np.float64))),
              "point": as_param(point)}

    def fn(q, p):
        return _mdot(q["point"] - p, q["normal"])

    return fn, params


@sdf3
def slab(x0=None, y0=None, z0=None, x1=None, y1=None, z1=None, k=None):
    fs = []
    if x0 is not None:
        fs.append(plane(X, (x0, 0, 0)))
    if x1 is not None:
        fs.append(plane(-X, (x1, 0, 0)))
    if y0 is not None:
        fs.append(plane(Y, (0, y0, 0)))
    if y1 is not None:
        fs.append(plane(-Y, (0, y1, 0)))
    if z0 is not None:
        fs.append(plane(Z, (0, 0, z0)))
    if z1 is not None:
        fs.append(plane(-Z, (0, 0, z1)))
    return intersection(*fs, k=k)


@sdf3
def box(size=1, center=ORIGIN, a=None, b=None):
    if a is not None and b is not None:
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        size = b - a
        center = a + size / 2
        return box(size, center)
    params = {"size": as_param(size), "center": as_param(center)}

    def fn(q, p):
        d = abs(p - q["center"]) - q["size"] / 2
        return _length(_pmax(d, 0)) + _min(d.hmax(), 0)

    return fn, params


@sdf3
def rounded_box(size, radius):
    params = {"size": as_param(size), "radius": as_param(radius)}

    def fn(q, p):
        d = abs(p) - q["size"] / 2 + q["radius"]
        return _length(_pmax(d, 0)) + _min(d.hmax(), 0) - q["radius"]

    return fn, params


@sdf3
def wireframe_box(size, thickness):
    params = {"size": as_param(size), "thickness": as_param(thickness)}

    def g(a, b, c):
        return _length(_pmax(_vec(a, b, c), 0)) + _min(_max(a, _max(b, c)), 0)

    def fn(q, p):
        thickness = q["thickness"]
        p = abs(p) - q["size"] / 2 - thickness / 2
        d = abs(p + thickness / 2) - thickness / 2
        px, py, pz = p.c
        qx, qy, qz = d.c
        return _min(_min(g(px, qy, qz), g(qx, py, qz)), g(qx, qy, pz))

    return fn, params


@sdf3
def torus(r1, r2):
    params = {"r1": as_param(r1), "r2": as_param(r2)}

    def fn(q, p):
        a = _length(p[:, :2]) - q["r1"]
        return _length(_vec(a, p[:, 2])) - q["r2"]

    return fn, params


@sdf3
def capsule(a, b, radius):
    params = {"a": as_param(a), "b": as_param(b), "radius": as_param(radius)}

    def fn(q, p):
        pa = p - q["a"]
        ba = q["b"] - q["a"]
        h = clip(_mdot(pa, ba) / vm._dotv(ba, ba), 0, 1)
        return _length(pa - _vmul(ba, h)) - q["radius"]

    return fn, params


@sdf3
def cylinder(radius):
    params = {"radius": as_param(radius)}

    def fn(q, p):
        return _length(p[:, :2]) - q["radius"]

    return fn, params


@sdf3
def capped_cylinder(a, b, radius):
    params = {"a": as_param(a), "b": as_param(b), "radius": as_param(radius)}

    def fn(q, p):
        ba = q["b"] - q["a"]
        pa = p - q["a"]
        baba = vm._dotv(ba, ba)
        paba = _mdot(pa, ba)
        x = _length(pa * baba - _vmul(ba, paba)) - q["radius"] * baba
        y = vm._abs(paba - baba * 0.5) - baba * 0.5
        x2 = x * x
        y2 = y * y * baba
        d = torch.where(
            _max(x, y) < 0,
            -_min(x2, y2),
            torch.where(x > 0, x2, 0.0) + torch.where(y > 0, y2, 0.0),
        )
        return torch.sign(d) * vm.sqrt(vm._abs(d)) / baba

    return fn, params


@sdf3
def rounded_cylinder(ra, rb, h):
    params = {"ra": as_param(ra), "rb": as_param(rb), "h": as_param(h)}

    def fn(q, p):
        d = _vec(
            _length(p[:, :2]) - q["ra"] + q["rb"],
            vm._abs(p[:, 2]) - q["h"] / 2 + q["rb"],
        )
        return _min(_max(d.c[0], d.c[1]), 0) + _length(_pmax(d, 0)) - q["rb"]

    return fn, params


@sdf3
def capped_cone(a, b, ra, rb):
    params = {
        "a": as_param(a),
        "b": as_param(b),
        "ra": as_param(ra),
        "rb": as_param(rb),
    }

    def fn(q, p):
        a_, b_, ra_, rb_ = q["a"], q["b"], q["ra"], q["rb"]
        rba = rb_ - ra_
        baba = vm._dotv(b_ - a_, b_ - a_)
        pa = p - a_
        papa = _dot(pa, pa)
        paba = _mdot(pa, b_ - a_) / baba
        x = vm.sqrt(_max(papa - paba * paba * baba, 0))
        cax = _max(0, x - torch.where(paba < 0.5, ra_, rb_))
        cay = vm._abs(paba - 0.5) - 0.5
        k = rba * rba + baba
        f = clip((rba * (x - ra_) + paba * baba) / k, 0, 1)
        cbx = x - ra_ - f * rba
        cby = paba - f
        s = torch.where(torch.logical_and(cbx < 0, cay < 0), -1.0, 1.0)
        return s * vm.sqrt(
            _min(cax * cax + cay * cay * baba, cbx * cbx + cby * cby * baba)
        )

    return fn, params


@sdf3
def rounded_cone(r1, r2, h):
    params = {"r1": as_param(r1), "r2": as_param(r2), "h": as_param(h)}

    def fn(q, p):
        r1_, r2_, h_ = q["r1"], q["r2"], q["h"]
        d = _vec(_length(p[:, :2]), p[:, 2])
        b = (r1_ - r2_) / h_
        a = vm.sqrt(_max(1 - b * b, 0))
        k = d.c[0] * -b + d.c[1] * a
        c1 = _length(d) - r1_
        c2 = _length(_vec(d.c[0], d.c[1] - h_)) - r2_
        c3 = d.c[0] * a + d.c[1] * b - r1_
        return torch.where(k < 0, c1, torch.where(k > a * h_, c2, c3))

    return fn, params


@sdf3
def ellipsoid(size):
    # A distance bound, not an exact SDF.
    params = {"size": as_param(size)}

    def fn(q, p):
        size_ = q["size"]
        k0 = _length(p / size_)
        k1 = _length(p / (size_ * size_))
        return k0 * (k0 - 1) / k1

    return fn, params


@sdf3
def pyramid(h):
    params = {"h": as_param(h)}

    def fn(q, p):
        h_ = q["h"]
        a = abs(p[:, :2]) - 0.5
        w = a.c[1] > a.c[0]
        ax = torch.where(w, a.c[1], a.c[0])
        az = torch.where(w, a.c[0], a.c[1])
        px = ax
        py = p[:, 2]
        pz = az
        m2 = h_ * h_ + 0.25
        qx = pz
        qy = h_ * py - 0.5 * px
        qz = h_ * px + 0.5 * py
        s = _max(-qx, 0)
        t = clip((qy - 0.5 * pz) / (m2 + 0.25), 0, 1)
        a_ = m2 * (qx + s) ** 2 + qy * qy
        b_ = m2 * (qx + 0.5 * t) ** 2 + (qy - m2 * t) ** 2
        d2 = torch.where(_min(qy, -qx * m2 - qy * 0.5) > 0, 0.0, _min(a_, b_))
        return vm.sqrt((d2 + qz * qz) / m2) * torch.sign(_max(qz, -py))

    return fn, params


# Platonic Solids


@sdf3
def tetrahedron(r):
    params = {"r": as_param(r)}

    def fn(q, p):
        x, y, z = p.c
        return _div_const(
            _max(vm._abs(x + y) - z, vm._abs(x - y) + z) - q["r"],
            float(np.sqrt(3)),
        )

    return fn, params


@sdf3
def octahedron(r):
    params = {"r": as_param(r)}

    def fn(q, p):
        return (abs(p).hsum() - q["r"]) * float(np.tan(np.radians(30)))

    return fn, params


@sdf3
def dodecahedron(r):
    x, y, z = _normalize(np.array(((1 + np.sqrt(5)) / 2, 1, 0)))
    params = {"r": as_param(r)}

    def fn(q, p):
        r_ = q["r"]
        p = abs(p / r_)
        a = _mdot(p, np.array((x, y, z)))
        b = _mdot(p, np.array((z, x, y)))
        c = _mdot(p, np.array((y, z, x)))
        return (_max(_max(a, b), c) - float(x)) * r_

    return fn, params


@sdf3
def icosahedron(r):
    r = float(r) * 0.8506507174597755
    x, y, z = _normalize(np.array(((np.sqrt(5) + 3) / 2, 1, 0)))
    w = np.sqrt(3) / 3
    params = {"r": as_param(r)}

    def fn(q, p):
        r_ = q["r"]
        p = abs(p / r_)
        a = _mdot(p, np.array((x, y, z)))
        b = _mdot(p, np.array((z, x, y)))
        c = _mdot(p, np.array((y, z, x)))
        d = _mdot(p, np.array((w, w, w))) - float(x)
        return _max(_max(_max(a, b), c) - float(x), d) * r_

    return fn, params


# Positioning


@op3
def translate(other, offset):
    params = {"other": other, "offset": as_param(offset)}

    def fn(q, p):
        return q["other"](p - q["offset"])

    return fn, params


@op3
def scale(other, factor):
    try:
        x, y, z = factor
    except TypeError:
        x = y = z = factor
    # Non-uniform scale multiplies by min(x, y, z): an inexact SDF.
    params = {
        "other": other,
        "s": as_param((x, y, z)),
        "m": as_param(min(x, min(y, z))),
    }

    def fn(q, p):
        return q["other"](p / q["s"]) * q["m"]

    return fn, params


@op3
def rotate(other, angle, vector=Z):
    x, y, z = _normalize(np.asarray(vector, dtype=np.float64))
    s = np.sin(angle)
    c = np.cos(angle)
    m = 1 - c
    matrix = np.array(
        [
            [m * x * x + c, m * x * y + z * s, m * z * x - y * s],
            [m * x * y - z * s, m * y * y + c, m * y * z + x * s],
            [m * z * x + y * s, m * y * z - x * s, m * z * z + c],
        ]
    ).T
    params = {"other": other, "matrix": as_param(matrix)}

    def fn(q, p):
        return q["other"](_mdot(p, q["matrix"]))

    return fn, params


@op3
def rotate_to(other, a, b):
    a = _normalize(np.asarray(a, dtype=np.float64))
    b = _normalize(np.asarray(b, dtype=np.float64))
    dot = np.dot(b, a)
    if dot == 1:
        return other
    if dot == -1:
        return rotate(other, np.pi, _perpendicular(a))
    angle = np.arccos(dot)
    v = _normalize(np.cross(b, a))
    return rotate(other, angle, v)


@op3
def orient(other, axis):
    return rotate_to(other, UP, axis)


@op3
def circular_array(other, count, offset=0):
    # Evaluates the child only twice (the two nearest angular copies).
    other = other.translate(X * offset)
    da = 2 * np.pi / count
    params = {"other": other}

    def fn(q, p):
        x, y, z = p.c
        d = vm.hypot(x, y)
        a = vm._mod(vm.arctan2(y, x), da)
        d1 = q["other"](_vec(torch.cos(a - da) * d, torch.sin(a - da) * d, z))
        d2 = q["other"](_vec(torch.cos(a) * d, torch.sin(a) * d, z))
        return _min(d1, d2)

    return fn, params


# Alterations


@op3
def elongate(other, size):
    params = {"other": other, "size": as_param(size)}

    def fn(q, p):
        d = abs(p) - q["size"]
        x, y, z = d.c
        w = _min(_max(x, _max(y, z)), 0)
        return q["other"](_pmax(d, 0)) + w

    return fn, params


@op3
def twist(other, k):
    params = {"other": other, "k": as_param(k)}

    def fn(q, p):
        x, y, z = p.c
        c = torch.cos(q["k"] * z)
        s = torch.sin(q["k"] * z)
        x2 = c * x - s * y
        y2 = s * x + c * y
        return q["other"](_vec(x2, y2, z))

    return fn, params


@op3
def bend(other, k):
    params = {"other": other, "k": as_param(k)}

    def fn(q, p):
        x, y, z = p.c
        c = torch.cos(q["k"] * x)
        s = torch.sin(q["k"] * x)
        x2 = c * x - s * y
        y2 = s * x + c * y
        return q["other"](_vec(x2, y2, z))

    return fn, params


@op3
def bend_linear(other, p0, p1, v, e=ease.linear):
    params = {
        "other": other,
        "p0": as_param(p0),
        "v": -as_param(v),
        "ab": as_param(p1) - as_param(p0),
    }

    def fn(q, p):
        ab = q["ab"]
        t = clip(_mdot(p - q["p0"], ab) / vm._dotv(ab, ab), 0, 1)
        return q["other"](p + _vmul(q["v"], e(t)))

    return fn, params


@op3
def bend_radial(other, r0, r1, dz, e=ease.linear):
    params = {"other": other, "r0": as_param(r0), "r1": as_param(r1), "dz": as_param(dz)}

    def fn(q, p):
        x, y, z = p.c
        r = vm.hypot(x, y)
        t = clip((r - q["r0"]) / (q["r1"] - q["r0"]), 0, 1)
        z = z - q["dz"] * e(t)
        return q["other"](_vec(x, y, z))

    return fn, params


@op3
def transition_linear(f0, f1, p0=-Z, p1=Z, e=ease.linear):
    params = {
        "f0": f0,
        "f1": f1,
        "p0": as_param(p0),
        "ab": as_param(p1) - as_param(p0),
    }

    def fn(q, p):
        d1 = q["f0"](p)
        d2 = q["f1"](p)
        ab = q["ab"]
        t = clip(_mdot(p - q["p0"], ab) / vm._dotv(ab, ab), 0, 1)
        t = e(t)
        return t * d2 + (1 - t) * d1

    return fn, params


@op3
def transition_radial(f0, f1, r0=0, r1=1, e=ease.linear):
    params = {"f0": f0, "f1": f1, "r0": as_param(r0), "r1": as_param(r1)}

    def fn(q, p):
        d1 = q["f0"](p)
        d2 = q["f1"](p)
        r = vm.hypot(p.c[0], p.c[1])
        t = clip((r - q["r0"]) / (q["r1"] - q["r0"]), 0, 1)
        t = e(t)
        return t * d2 + (1 - t) * d1

    return fn, params


@op3
def wrap_around(other, x0, x1, r=None, e=ease.linear):
    p0 = X * np.float64(x0)
    p1 = X * np.float64(x1)
    v = -Y.astype(np.float64)
    if r is None:
        r = np.linalg.norm(p1 - p0) / (2 * np.pi)
    params = {
        "other": other,
        "p0": as_param(p0),
        "p1": as_param(p1),
        "v": as_param(v),
        "r": as_param(r),
    }

    def fn(q, p):
        x, y, z = p.c
        d = vm.hypot(x, y) - q["r"]
        a = vm.arctan2(y, x)
        t = e(_div_const(a + math.pi, 2 * math.pi))
        p0_, p1_, v_ = q["p0"], q["p1"], q["v"]
        wx = p0_[0] + (p1_[0] - p0_[0]) * t + v_[0] * d
        wy = p0_[1] + (p1_[1] - p0_[1]) * t + v_[1] * d
        return q["other"](_vec(wx, wy, z))

    return fn, params


# 3D => 2D Operations


@op32
def slice(other):
    # Slice the z=0 plane into a 2D SDF.
    s = slab(z0=-1e-9, z1=1e-9)
    a = other & s
    b = other.negate() & s
    params = {"a": a, "b": b}

    def fn(q, p):
        w = _vec(p.c[0], p.c[1], torch.zeros_like(p.c[0]))
        A = q["a"](w)
        B = -q["b"](w)
        return torch.where(A <= 0, B, A)

    return fn, params


# Common n-D CSG ops registered for SDF3

union = op3(csg.union)
difference = op3(csg.difference)
intersection = op3(csg.intersection)
blend = op3(csg.blend)
negate = op3(csg.negate)
dilate = op3(csg.dilate)
erode = op3(csg.erode)
shell = op3(csg.shell)
repeat = op3(csg.repeat)

__all__ = [
    "ORIGIN", "X", "Y", "Z", "UP", "SDF3", "Points",
    "sphere", "plane", "slab", "box", "rounded_box", "wireframe_box",
    "torus", "capsule", "cylinder", "capped_cylinder", "rounded_cylinder",
    "capped_cone", "rounded_cone", "ellipsoid", "pyramid", "tetrahedron",
    "octahedron", "dodecahedron", "icosahedron", "translate", "scale",
    "rotate", "rotate_to", "orient", "circular_array", "elongate", "twist",
    "bend", "bend_linear", "bend_radial", "transition_linear",
    "transition_radial", "wrap_around", "slice", "union", "difference",
    "intersection", "blend", "negate", "dilate", "erode", "shell", "repeat",
]
