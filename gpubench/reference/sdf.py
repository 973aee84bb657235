"""A frozen, plain copy of the SDF primitives and operations that the
benchmark's configurations use, with the public names of fogleman/sdf.

The benchmark builds each configuration's expression twice with one
function (``build`` in ``configs/<name>.py``): once with the program's
DSL, which is timed, and once with this module, which is the reference
the timed meshes are held against.  This module imports nothing of the program.

Every formula keeps the operation order of the program's ops term for term
(and so of the JAX package they follow): Python ``sum`` from integer 0,
``clip`` as ``minimum(hi, maximum(lo, x))``, ``hypot`` as ``jnp.hypot``,
the double-``where`` length, division only by tensors or powers of two.
Parameters are float64 at construction and become 0-d or 1-d tensors of
the compute dtype on the compute device when a field is evaluated
(``field``), so the same torch calls run on the same operand kinds.  On the
CPU the square root is numpy's (correctly rounded), as the card's is.
"""

from __future__ import annotations

import functools
import math
import numbers

import numpy as np
import torch

pi = math.pi
ORIGIN = np.array((0, 0, 0))
X = np.array((1, 0, 0))
Y = np.array((0, 1, 0))
Z = np.array((0, 0, 1))
UP = Z


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else ()


class Points:
    """Structure-of-arrays points: one broadcastable tensor per axis."""

    __slots__ = ("c",)
    __array_ufunc__ = None
    __array_priority__ = 1000

    def __init__(self, *c):
        self.c = tuple(c)

    @property
    def dim(self):
        return len(self.c)

    @property
    def bshape(self):
        return torch.broadcast_shapes(*[_shape(x) for x in self.c])

    def __getitem__(self, key):
        if isinstance(key, tuple) and len(key) == 2:
            key = key[1]
        if isinstance(key, slice):
            return Points(*self.c[key])
        return self.c[key]

    def _coerce(self, other):
        if isinstance(other, Points):
            return other.c
        shape = _shape(other)
        if len(shape) == 1 and shape[0] == self.dim:
            return tuple(other[i] for i in range(self.dim))
        return (other,) * self.dim

    def _bin(self, other, op):
        return Points(*[op(a, b) for a, b in zip(self.c, self._coerce(other))])

    def __add__(self, o):
        return self._bin(o, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._bin(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._bin(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin(o, lambda a, b: a / b)

    def __neg__(self):
        return Points(*[-a for a in self.c])

    def __abs__(self):
        return Points(*[torch.abs(a) for a in self.c])

    def hmax(self):
        return functools.reduce(torch.maximum, self.c)


# --- scalar helpers ----------------------------------------------------------


def _is_num(x):
    return isinstance(x, numbers.Number)


def _clamp_num(x, b, upper):
    return torch.clamp(x, max=b) if upper else torch.clamp(x, min=b)


def _min(a, b):
    if _is_num(a) and _is_num(b):
        return min(a, b)
    if _is_num(b):
        return _clamp_num(a, b, True)
    if _is_num(a):
        return _clamp_num(b, a, True)
    return torch.minimum(a, b)


def _max(a, b):
    if _is_num(a) and _is_num(b):
        return max(a, b)
    if _is_num(b):
        return _clamp_num(a, b, False)
    if _is_num(a):
        return _clamp_num(b, a, False)
    return torch.maximum(a, b)


def sqrt(x):
    """Correctly rounded: numpy's on the CPU (torch's CPU sqrt is not)."""
    if (isinstance(x, torch.Tensor) and x.device.type == "cpu"
            and x.dtype in (torch.float32, torch.float64)):
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))
    return torch.sqrt(x)


def clip(x, lo, hi):
    return _min(hi, _max(lo, x))


def hypot(x1, x2):
    x1, x2 = torch.abs(x1), torch.abs(x2)
    idx_inf = (x1 == math.inf) | (x2 == math.inf)
    x1, x2 = torch.maximum(x1, x2), torch.minimum(x1, x2)
    r = x2 / torch.where(x1 == 0, 1.0, x1)
    x = torch.where(x1 == 0, x1, x1 * sqrt(1 + r * r))
    return torch.where(idx_inf, math.inf, x)


def _mod(a, b):
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _length(a):
    sq = sum(c * c for c in a.c)
    return torch.where(sq == 0, 0.0, sqrt(torch.where(sq == 0, 1.0, sq)))


def _normalize(a):
    return a / np.linalg.norm(a)


def _entry(m, *idx):
    if isinstance(m, np.ndarray):
        return float(m[idx])
    return m[idx]


def _mdot(p, m):
    if len(m.shape) == 1:
        return sum(c * _entry(m, i) for i, c in enumerate(p.c))
    return Points(*[sum(c * _entry(m, i, j) for i, c in enumerate(p.c))
                    for j in range(m.shape[1])])


def _dotv(a, b):
    return sum(a[i] * b[i] for i in range(a.shape[0]))


def _vmul(v, s):
    return Points(*[_entry(v, i) * s for i in range(v.shape[0])])


def _pmax(a, b):
    return Points(*[_max(x, b) for x in a.c])


def _param(v):
    return np.asarray(v, dtype=np.float64)


# --- nodes -------------------------------------------------------------------


class SDF3:
    """An expression node: ``fn(q, p)`` over the parameter tree ``params``
    (child nodes inside it), and the smooth-blend tag ``_k``."""

    def __init__(self, fn, params):
        self.fn = fn
        self.params = params
        self._k = None

    def __call__(self, p):
        return self.fn(self.params, p)

    def k(self, k=None):
        self._k = k
        return self

    def __or__(self, other):
        return union(self, other)

    def __sub__(self, other):
        return difference(self, other)

    def union(self, *bs, k=None):
        return union(self, *bs, k=k)

    def translate(self, offset):
        return translate(self, offset)

    def rotate(self, angle, vector=Z):
        return rotate(self, angle, vector)

    def orient(self, axis):
        return orient(self, axis)

    def circular_array(self, count, offset=0):
        return circular_array(self, count, offset)

    def twist(self, k):
        return twist(self, k)


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, SDF3):
        obj = object.__new__(SDF3)
        obj.fn = tree.fn
        obj.params = _tree_map(fn, tree.params)
        obj._k = _tree_map(fn, tree._k)
        return obj
    if isinstance(tree, dict):
        return {key: _tree_map(fn, v) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    return fn(tree)


def cast(node, dtype, device):
    """Copy of ``node`` with every parameter a ``dtype`` tensor on
    ``device`` (float64 rounded to ``dtype`` once)."""
    def leaf(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dtype).reshape(
            np.shape(v)).to(device)

    return _tree_map(leaf, node)


# --- primitives --------------------------------------------------------------


def sphere(radius=1, center=ORIGIN):
    def fn(q, p):
        return _length(p - q["center"]) - q["radius"]

    return SDF3(fn, {"radius": _param(radius), "center": _param(center)})


def box(size=1, center=ORIGIN):
    def fn(q, p):
        d = abs(p - q["center"]) - q["size"] / 2
        return _length(_pmax(d, 0)) + _min(d.hmax(), 0)

    return SDF3(fn, {"size": _param(size), "center": _param(center)})


def capsule(a, b, radius):
    def fn(q, p):
        pa = p - q["a"]
        ba = q["b"] - q["a"]
        h = clip(_mdot(pa, ba) / _dotv(ba, ba), 0, 1)
        return _length(pa - _vmul(ba, h)) - q["radius"]

    return SDF3(fn, {"a": _param(a), "b": _param(b),
                     "radius": _param(radius)})


def cylinder(radius):
    def fn(q, p):
        return _length(p[:, :2]) - q["radius"]

    return SDF3(fn, {"radius": _param(radius)})


def rounded_cylinder(ra, rb, h):
    def fn(q, p):
        d = Points(
            _length(p[:, :2]) - q["ra"] + q["rb"],
            torch.abs(p[:, 2]) - q["h"] / 2 + q["rb"],
        )
        return _min(_max(d.c[0], d.c[1]), 0) + _length(_pmax(d, 0)) - q["rb"]

    return SDF3(fn, {"ra": _param(ra), "rb": _param(rb), "h": _param(h)})


# --- positioning and deformation --------------------------------------------


def translate(other, offset):
    def fn(q, p):
        return q["other"](p - q["offset"])

    return SDF3(fn, {"other": other, "offset": _param(offset)})


def rotate(other, angle, vector=Z):
    x, y, z = _normalize(np.asarray(vector, dtype=np.float64))
    s = np.sin(angle)
    c = np.cos(angle)
    m = 1 - c
    matrix = np.array([
        [m * x * x + c, m * x * y + z * s, m * z * x - y * s],
        [m * x * y - z * s, m * y * y + c, m * y * z + x * s],
        [m * z * x + y * s, m * y * z - x * s, m * z * z + c],
    ]).T

    def fn(q, p):
        return q["other"](_mdot(p, q["matrix"]))

    return SDF3(fn, {"other": other, "matrix": _param(matrix)})


def _perpendicular(v):
    if v[1] == 0 and v[2] == 0:
        return np.cross(v, [0, 1, 0])
    return np.cross(v, [1, 0, 0])


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


def orient(other, axis):
    return rotate_to(other, UP, axis)


def circular_array(other, count, offset=0):
    other = other.translate(X * offset)
    da = 2 * np.pi / count

    def fn(q, p):
        x, y, z = p.c
        d = hypot(x, y)
        a = _mod(torch.atan2(y, x), da)
        d1 = q["other"](Points(torch.cos(a - da) * d, torch.sin(a - da) * d, z))
        d2 = q["other"](Points(torch.cos(a) * d, torch.sin(a) * d, z))
        return _min(d1, d2)

    return SDF3(fn, {"other": other})


def twist(other, k):
    def fn(q, p):
        x, y, z = p.c
        c = torch.cos(q["k"] * z)
        s = torch.sin(q["k"] * z)
        return q["other"](Points(c * x - s * y, s * x + c * y, z))

    return SDF3(fn, {"other": other, "k": _param(k)})


# --- CSG ---------------------------------------------------------------------


def _resolve_k(k_param, b):
    return k_param if k_param is not None else getattr(b, "_k", None)


def union(a, *bs, k=None):
    def fn(q, p):
        d1 = q["a"](p)
        for b in q["bs"]:
            d2 = b(p)
            K = _resolve_k(q["k"], b)
            if K is None:
                d1 = torch.minimum(d1, d2)
            else:
                h = clip(0.5 + 0.5 * (d2 - d1) / K, 0, 1)
                m = d2 + (d1 - d2) * h
                d1 = m - K * h * (1 - h)
        return d1

    return SDF3(fn, {"a": a, "bs": list(bs), "k": _param(k) if k else None})


def difference(a, *bs, k=None):
    def fn(q, p):
        d1 = q["a"](p)
        for b in q["bs"]:
            d2 = b(p)
            K = _resolve_k(q["k"], b)
            if K is None:
                d1 = torch.maximum(d1, -d2)
            else:
                h = clip(0.5 - 0.5 * (d2 + d1) / K, 0, 1)
                m = d1 + (-d2 - d1) * h
                d1 = m + K * h * (1 - h)
        return d1

    return SDF3(fn, {"a": a, "bs": list(bs), "k": _param(k) if k else None})


def field(node, dtype, device):
    """The expression as a function of ``Points`` in ``dtype`` on
    ``device``."""
    return cast(node, dtype, device)
