"""Easing curves ``t in [0,1] -> R`` (counterpart of ``sdf_tpu.ops.easing``).

Each family is defined once by its core acceleration curve; the
decelerating and in-out members derive from it by reflection
(``out(t) = 1 - in(1 - t)``) and symmetrization, exactly as in the JAX
package.  Curves take and return tensors (Python numbers and numpy arrays
are converted), so they evaluate inside SDF expressions on any device.
"""

from __future__ import annotations

import math
import numbers
from functools import partial

import numpy as np
import torch

from .vecmath import _max, sqrt


def _t(t):
    """Tensors (and the kernel recorder's values) pass through; Python
    numbers and numpy arrays become float64 tensors."""
    if isinstance(t, (numbers.Number, np.ndarray, list, tuple)):
        return torch.as_tensor(t, dtype=torch.float64)
    return t


def _named(name, f):
    f.__name__ = f.__qualname__ = name
    return f


def reflected(ease_in, name=None):
    """Derive the decelerating curve: ``out(t) = 1 - in(1 - t)``."""

    def out(t, *args, **kw):
        return 1 - ease_in(1 - _t(t), *args, **kw)

    return _named(name or "out", out)


def symmetrized(ease_in, name=None):
    """Derive the ease-in-out curve: accelerate into t=1/2, then the
    point-reflected deceleration out of it."""

    def in_out(t, *args, **kw):
        t = _t(t)
        first = ease_in(2 * t, *args, **kw) / 2
        second = 1 - ease_in(2 - 2 * t, *args, **kw) / 2
        return torch.where(t < 0.5, first, second)

    return _named(name or "in_out", in_out)


def _trio(ease_in, stem, in_out_core=None):
    return (
        _named("in_" + stem, ease_in),
        reflected(ease_in, "out_" + stem),
        symmetrized(in_out_core or ease_in, "in_out_" + stem),
    )


def linear(t):
    return t


def _power(t, p):
    return _t(t) ** p


in_quad, out_quad, in_out_quad = _trio(partial(_power, p=2), "quad")
in_cubic, out_cubic, in_out_cubic = _trio(partial(_power, p=3), "cubic")
in_quart, out_quart, in_out_quart = _trio(partial(_power, p=4), "quart")
in_quint, out_quint, in_out_quint = _trio(partial(_power, p=5), "quint")


def _sine(t):
    return 1 - torch.cos(_t(t) * (math.pi / 2))


in_sine, out_sine, in_out_sine = _trio(_sine, "sine")


def _expo(t):
    # 2^(10(t-1)) with the exact-zero pin at t == 0.
    t = _t(t)
    return torch.where(t == 0, 0.0, 2.0 ** (10 * (t - 1)))


in_expo, out_expo, in_out_expo = _trio(_expo, "expo")


def _circ(t):
    # Guarded sqrt: symmetrized() evaluates both branches.
    t = _t(t)
    return 1 - sqrt(_max(1 - t * t, 0))


in_circ, out_circ, in_out_circ = _trio(_circ, "circ")


def _elastic(t, k=0.5):
    u = _t(t) - 1
    return -(2.0 ** (10 * u)) * torch.sin((u - k / 4) * (2 * math.pi) / k)


in_elastic, out_elastic, in_out_elastic = _trio(_elastic, "elastic")


def _back(t, k):
    t = _t(t)
    return t * t * ((k + 1) * t - k)


in_back, out_back, in_out_back = _trio(
    partial(_back, k=1.70158), "back",
    in_out_core=partial(_back, k=1.70158 * 1.525),
)


def out_bounce(t):
    t = _t(t)
    a = (121 * t * t) / 16
    b = (363 / 40 * t * t) - (99 / 10 * t) + 17 / 5
    c = (4356 / 361 * t * t) - (35442 / 1805 * t) + 16061 / 1805
    d = (54 / 5 * t * t) - (513 / 25 * t) + 268 / 25
    return torch.where(
        t < 4 / 11, a, torch.where(t < 8 / 11, b, torch.where(t < 9 / 10, c, d))
    )


in_bounce = reflected(out_bounce, "in_bounce")
in_out_bounce = symmetrized(in_bounce, "in_out_bounce")


def in_square(t):
    t = _t(t)
    return torch.where(t < 1, torch.zeros_like(t), torch.ones_like(t))


def out_square(t):
    t = _t(t)
    return torch.where(t > 0, torch.ones_like(t), torch.zeros_like(t))


def in_out_square(t):
    t = _t(t)
    return torch.where(t < 0.5, torch.zeros_like(t), torch.ones_like(t))
