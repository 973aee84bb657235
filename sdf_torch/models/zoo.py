"""The reference workload suite as parameterized SDF constructors (counterpart
of ``sdf_tpu.models.zoo``).

Each function reconstructs the geometry of one example script through the
modelling API and returns the expression tree; every numeric argument
becomes a parameter leaf.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.node import sdf3
from ..ops import easing as ease
from ..ops.shapes3 import (
    X,
    Y,
    Z,
    box,
    capsule,
    cylinder,
    rounded_box,
    rounded_cylinder,
    slab,
    sphere,
)

pi = np.pi


def example(radius=1.0, size=1.5, hole=0.5):
    """Canonical CSG demo: sphere & box minus three cylinders."""
    f = sphere(radius) & box(size)
    c = cylinder(hole)
    f -= c.orient(X) | c.orient(Y) | c.orient(Z)
    return f


def blobby(r_small=0.75, r_big=1.5, cap_r=0.5, spread=3.0, k=1.0):
    """Smooth-union blob cross."""
    s = sphere(r_small)
    s = s.translate(Z * -spread) | s.translate(Z * spread)
    s = s.union(capsule(Z * -spread, Z * spread, cap_r), k=k)
    return sphere(r_big).union(s.orient(X), s.orient(Y), s.orient(Z), k=k)


def gearlike(radius=2.0, half_height=0.5, bore=1.0, tooth_r=0.25, n_teeth=16,
             ring_r=2.0, k=0.1):
    """Smooth-blended gear body."""
    f = sphere(radius) & slab(z0=-half_height, z1=half_height).k(k)
    f -= cylinder(bore).k(k)
    f -= cylinder(tooth_r).circular_array(n_teeth, ring_r).k(k)
    return f


def knurling(body_r=1.0, body_round=0.1, body_h=5.0, k=0.1):
    """Knurled cylinder with vents."""
    f = rounded_cylinder(body_r, body_round, body_h)
    x = box((1, 1, 4)).rotate(pi / 4)
    x = x.circular_array(24, 1.6)
    x = x.twist(0.75) | x.twist(-0.75)
    f -= x.k(k)
    f -= cylinder(0.5).k(k)
    c = cylinder(0.25).orient(X)
    f -= c.translate(Z * -2.5).k(k)
    f -= c.translate(Z * 2.5).k(k)
    return f


def _pawn_section(z0, z1, d0, d1, e=ease.linear):
    """One lathe section."""
    f = cylinder(d0 / 2).transition_linear(cylinder(d1 / 2), Z * z0, Z * z1, e)
    return f & slab(z0=z0, z1=z1)


def pawn():
    """Chess pawn from eased transition sections."""
    f = _pawn_section(0, 0.2, 1, 1.25)
    f |= _pawn_section(0.2, 0.3, 1.25, 1).k(0.05)
    f |= rounded_cylinder(0.6, 0.1, 0.2).translate(Z * 0.4).k(0.05)
    f |= _pawn_section(0.5, 1.75, 1, 0.25, ease.out_quad).k(0.01)
    f |= _pawn_section(1.75, 1.85, 0.25, 0.5).k(0.01)
    f |= _pawn_section(1.85, 1.90, 0.5, 0.25).k(0.05)
    f |= sphere(0.3).translate(Z * 2.15).k(0.05)
    return f


def weave():
    """Woven disc: bent strips, lattice repeat, rim."""
    f = rounded_box([3.2, 1, 0.25], 0.1).translate((1.5, 0, 0.0625))
    f = f.bend_linear(X * 0.75, X * 2.25, Z * -0.1875, ease.in_out_quad)
    f = f.circular_array(3, 0)
    f = f.repeat((2.7, 5.4, 0), padding=1)
    f |= f.translate((2.7 / 2, 2.7, 0))
    f &= cylinder(10)
    f |= (cylinder(12) - cylinder(10)) & slab(z0=-0.5, z1=0.5).k(0.25)
    return f


# --- customizable box -------------------

_BOX_DEFAULTS = dict(
    width=12.0,
    height=6.0,
    depth=2.0,
    rows=3,
    cols=5,
    wall_thickness=0.25,
    wall_radius=0.5,
    bottom_radius=0.25,
    top_fillet=0.125,
    divider_thickness=0.2,
    row_divider_depth=1.75,
    col_divider_depth=1.5,
    divider_fillet=0.1,
    lid_thickness=0.25,
    lid_depth=0.75,
    lid_radius=0.125,
)


def _box_dividers(c_):
    """Interior divider lattice."""
    col_spacing = c_["width"] / c_["cols"]
    row_spacing = c_["height"] / c_["rows"]
    c = rounded_box(
        (c_["divider_thickness"], 1e9, c_["col_divider_depth"]),
        c_["divider_fillet"],
    )
    c = c.translate(Z * c_["col_divider_depth"] / 2)
    c = c.repeat((col_spacing, 0, 0))
    r = rounded_box(
        (1e9, c_["divider_thickness"], c_["row_divider_depth"]),
        c_["divider_fillet"],
    )
    r = r.translate(Z * c_["row_divider_depth"] / 2)
    r = r.repeat((0, row_spacing, 0))
    if c_["cols"] % 2 != 0:
        c = c.translate((col_spacing / 2, 0, 0))
    if c_["rows"] % 2 != 0:
        r = r.translate((0, row_spacing / 2, 0))
    return c | r


def customizable_box_body(**overrides):
    """Parametric storage box with dividers."""
    c_ = {**_BOX_DEFAULTS, **overrides}
    d = _box_dividers(c_)
    p = c_["wall_thickness"]
    f = rounded_box((c_["width"] - p, c_["height"] - p, 1e9), c_["wall_radius"])
    f &= slab(z0=p / 2).k(c_["bottom_radius"])
    d &= f
    f = f.shell(c_["wall_thickness"])
    f &= slab(z1=c_["depth"]).k(c_["top_fillet"])
    return f | d


def customizable_box_lid(**overrides):
    """Matching lid."""
    c_ = {**_BOX_DEFAULTS, **overrides}
    p = c_["wall_thickness"]
    f = rounded_box((c_["width"] + p, c_["height"] + p, 1e9), c_["wall_radius"])
    f &= slab(z0=p / 2).k(c_["lid_radius"])
    f = f.shell(c_["lid_thickness"])
    f &= slab(z1=c_["lid_depth"]).k(c_["top_fillet"])
    return f


@sdf3
def gyroid(omega=40.0, t=0.2):
    """The gyroid level set ``cos x sin y + cos y sin z + cos z sin x = t``
    at frequency ``omega``, divided by ``omega * sqrt(3)`` (a bound on its
    gradient) so the field is a Lipschitz-1 distance UNDERESTIMATE: inexact
    but conservative."""
    params = {"omega": np.asarray(omega, np.float64),
              "t": np.asarray(t, np.float64)}

    def fn(q, p):
        x, y, z = (p * q["omega"]).c
        g = (
            torch.cos(x) * torch.sin(y)
            + torch.cos(y) * torch.sin(z)
            + torch.cos(z) * torch.sin(x)
        )
        return (g - q["t"]) * (1.0 / (q["omega"] * math.sqrt(3.0)))

    return fn, params


def saddle(omega=40.0, t=0.2, r=1.45):
    """Gyroid shell clipped to a sphere: the ambiguity-rich certificate
    model.

    The gyroid is saddle-shaped everywhere, so at a resolution where the
    period spans only a few cells (omega=40 -> ~8 cells/period at
    samples=2**22 in the +-r sphere) thousands of cells have diagonally
    alternating face signs -- exactly the marching-cubes ambiguities where
    the lewiner (trilinear-faithful, the generate() default) and fast
    (fixed separation) variants make DIFFERENT topology decisions.  A run
    whose lewiner path silently used the fast tables shows here and on no
    other model of the zoo.
    """
    return gyroid(omega, t) & sphere(r)


# name -> (constructor, default samples of the example script)
MODELS = {
    "example": (example, 2**22),
    "blobby": (blobby, 2**26),
    "gearlike": (gearlike, 2**26),
    "knurling": (knurling, 2**26),
    "pawn": (pawn, 2**26),
    "weave": (weave, 2**22),
    "customizable_box_body": (customizable_box_body, 2**24),
    "customizable_box_lid": (customizable_box_lid, 2**24),
}
