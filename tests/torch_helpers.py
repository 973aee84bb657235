"""Shared helpers of the tests that hold ``sdf_torch`` against ``sdf_tpu``.

Inputs are made with numpy from a seed and handed to both packages;
results come back as numpy arrays.
"""

import hashlib
import re

import numpy as np


def example(m):
    """The canonical example model (examples/example.py) built from the
    package ``m`` (sdf_tpu or sdf_torch)."""
    f = m.sphere(1) & m.box(1.5)
    c = m.cylinder(0.5)
    f -= c.orient(m.X) | c.orient(m.Y) | c.orient(m.Z)
    return f


def saddle_pair(omega=40.0, t=0.2, r=1.45):
    """The saddle (gyroid) model in both packages with the same parameters:
    ``(sdf_tpu expression, sdf_torch expression)``.  In sdf_tpu ``omega``
    and ``t`` are statics of a closure and only the clipping sphere has
    leaves; in sdf_torch all are leaves.  The port's model is built at its
    defaults and receives the values through ``load_leaves``: the two
    closure statics first, then the JAX tree's leaves (the sphere's centre
    and radius)."""
    import jax

    from sdf_tpu.models import zoo as jzoo
    from sdf_torch.core.node import load_leaves
    from sdf_torch.models import zoo as tzoo

    fj = jzoo.saddle(omega, t, r)
    leaves = [np.asarray(omega), np.asarray(t)] + [
        np.asarray(x) for x in jax.tree_util.tree_leaves(fj)
    ]
    return fj, load_leaves(tzoo.saddle(), leaves)


def op_cases():
    """Every ported primitive and op: name -> (builder taking the package
    sdf_tpu or sdf_torch, tolerance class of tests/test_torch_ops.py)."""
    return {
        "sphere": (lambda m: m.sphere(0.8, center=(0.1, 0.2, -0.1)), "exact"),
        "plane": (lambda m: m.plane((1, 2, 3), (0.1, 0, 0)), "exact"),
        "slab": (lambda m: m.slab(x0=-0.5, z1=0.4, y0=-0.3), "exact"),
        "box": (lambda m: m.box((1, 0.8, 0.6), center=(0.1, 0, 0)), "exact"),
        "box_ab": (lambda m: m.box(a=(-0.5, -0.4, -0.3), b=(0.5, 0.3, 0.6)), "exact"),
        "rounded_box": (lambda m: m.rounded_box((1, 0.8, 0.6), 0.1), "exact"),
        "wireframe_box": (lambda m: m.wireframe_box((1, 0.8, 0.6), 0.05), "exact"),
        "torus": (lambda m: m.torus(0.6, 0.2), "exact"),
        "capsule": (lambda m: m.capsule((-0.5, 0, 0), (0.5, 0.2, 0.1), 0.2), "exact"),
        "cylinder": (lambda m: m.cylinder(0.4), "exact"),
        "capped_cylinder": (
            lambda m: m.capped_cylinder((-0.5, 0, 0), (0.5, 0.1, 0), 0.3), "exact"),
        "rounded_cylinder": (lambda m: m.rounded_cylinder(0.4, 0.1, 0.8), "exact"),
        "capped_cone": (
            lambda m: m.capped_cone((-0.5, 0, 0), (0.5, 0, 0.1), 0.4, 0.2), "exact"),
        "rounded_cone": (lambda m: m.rounded_cone(0.4, 0.2, 0.8), "exact"),
        "ellipsoid": (lambda m: m.ellipsoid((0.8, 0.6, 0.4)), "exact"),
        "pyramid": (lambda m: m.pyramid(1.0), "exact"),
        "tetrahedron": (lambda m: m.tetrahedron(0.7), "exact"),
        "octahedron": (lambda m: m.octahedron(0.7), "exact"),
        "dodecahedron": (lambda m: m.dodecahedron(0.7), "exact"),
        "icosahedron": (lambda m: m.icosahedron(0.7), "exact"),
        "translate": (lambda m: m.sphere(0.5).translate((0.1, 0.2, 0.3)), "exact"),
        "scale": (lambda m: m.sphere(0.5).scale((1, 2, 0.5)), "exact"),
        "rotate": (lambda m: m.box(0.8).rotate(0.3, (1, 1, 0)), "exact"),
        "rotate_to": (lambda m: m.box(0.8).rotate_to(m.X, (1, 1, 1)), "exact"),
        "orient": (lambda m: m.cylinder(0.3).orient(m.X), "exact"),
        "circular_array": (lambda m: m.sphere(0.2).circular_array(5, 0.6), "approx"),
        "elongate": (lambda m: m.sphere(0.3).elongate((0.2, 0.1, 0)), "exact"),
        "twist": (lambda m: m.box((0.6, 0.3, 1)).twist(1.0), "approx"),
        "bend": (lambda m: m.box((1, 0.3, 0.3)).bend(0.5), "approx"),
        "bend_linear": (
            lambda m: m.capsule((0, 0, -0.5), (0, 0, 0.5), 0.2).bend_linear(
                (0, 0, -0.5), (0, 0, 0.5), (0.3, 0, 0), m.ease.in_out_quad),
            "exact"),
        "bend_radial": (
            lambda m: m.box((1, 1, 0.2)).bend_radial(0.2, 0.8, 0.2, m.ease.in_out_sine),
            "approx"),
        "transition_linear": (
            lambda m: m.box(0.8).transition_linear(m.sphere(0.5)), "exact"),
        "transition_radial": (
            lambda m: m.box(0.8).transition_radial(m.sphere(0.5)), "approx"),
        "wrap_around": (lambda m: m.box((1, 0.2, 0.2)).wrap_around(-0.5, 0.5), "approx"),
        "union": (lambda m: m.sphere(0.5) | m.box(0.7).translate((0.3, 0, 0)), "exact"),
        "difference": (lambda m: m.box(0.8) - m.sphere(0.5), "exact"),
        "intersection": (lambda m: m.box(0.8) & m.sphere(0.55), "exact"),
        "union_k": (lambda m: m.sphere(0.5).union(m.box(0.7), k=0.1), "exact"),
        "difference_k": (lambda m: m.box(0.8).difference(m.sphere(0.5), k=0.1), "exact"),
        "intersection_k": (
            lambda m: m.box(0.8).intersection(m.sphere(0.55), k=0.1), "exact"),
        "tag_k": (lambda m: m.sphere(0.5) | m.box(0.7).k(0.2), "exact"),
        "blend": (lambda m: m.sphere(0.5).blend(m.box(0.7)), "exact"),
        "negate": (lambda m: m.sphere(0.5).negate(), "exact"),
        "dilate": (lambda m: m.sphere(0.5).dilate(0.1), "exact"),
        "erode": (lambda m: m.sphere(0.5).erode(0.1), "exact"),
        "shell": (lambda m: m.sphere(0.5).shell(0.1), "exact"),
        "repeat": (lambda m: m.sphere(0.1).repeat(0.3, count=2, padding=1), "exact"),
        "ease_cubic": (
            lambda m: m.box((1, 0.3, 0.3)).bend_linear(
                (-0.5, 0, 0), (0.5, 0, 0), (0, 0.2, 0), m.ease.in_out_cubic),
            "exact"),
        "ease_bounce": (
            lambda m: m.box((1, 0.3, 0.3)).bend_linear(
                (-0.5, 0, 0), (0.5, 0, 0), (0, 0.2, 0), m.ease.in_out_bounce),
            "exact"),
        "ease_expo": (
            lambda m: m.box((1, 0.3, 0.3)).bend_linear(
                (-0.5, 0, 0), (0.5, 0, 0), (0, 0.2, 0), m.ease.in_out_expo),
            "approx"),
        "example": (example, "exact"),
    }


def table_field(table, lo=-1.5, hi=1.5):
    """A gather-marked test SDF of sdf_torch: the heightfield ``z -
    table[i(x)]``, the table looked up by an index computed from ``x``
    (nearest of ``len(table)`` knots over ``[lo, hi]``).  The generated
    kernel body cannot hold the lookup, so ``core.hybrid`` computes its
    field ahead of the per-tile kernel.  The result broadcasts over y."""
    import torch

    from sdf_torch.core import hybrid
    from sdf_torch.core.node import SDF3, as_param

    n = len(table)

    @hybrid.mark_gather
    def table_field_fn(q, p):
        x, z = p[0], p[2]
        i = torch.clamp(torch.round((x - lo) * ((n - 1) / (hi - lo))), 0, n - 1)
        return z - q["table"][i.to(torch.int64)]

    return SDF3(table_field_fn, {"table": as_param(table)})


def gather_models(m):
    """Gather-bearing sdf_torch expressions (``m`` is sdf_torch): the table
    field under a rotation (its field is recorded at rotated points), and
    under ``circular_array``, whose parent evaluates the child twice (two
    fields, two reads)."""
    table = 0.25 * np.cos(np.linspace(0.0, 9.0, 25))
    return {
        "rotated": m.sphere(1.2) & table_field(table).rotate(0.5, m.X),
        "circular": m.sphere(1.2) & table_field(table).translate(
            (0.3, 0.0, 0.0)).circular_array(3, 0.0),
    }


def grid_tiles(shape, tile, rng=None, keep=0.5):
    """Tile indices of a grid of ``shape`` samples at ``tile`` cells per
    tile: all of them, or a random ``keep`` share (always with the first
    and the last, which clamps), as an (n, 3) int32 array in x-major order."""
    nt = [-(-n // tile) for n in shape]
    full = np.stack(np.meshgrid(*[np.arange(n) for n in nt], indexing="ij"),
                    axis=-1).reshape(-1, 3)
    if rng is not None:
        pick = rng.random(len(full)) < keep
        pick[0] = pick[-1] = True
        full = full[pick]
    return full.astype(np.int32)


def soup_hash(pts):
    """Canonical triangle-soup sha256 (tests/test_topology_2p24.py)."""
    tris = np.asarray(pts, np.float64).round(9).reshape(-1, 9)
    return hashlib.sha256(tris[np.lexsort(tris.T[::-1])].tobytes()).hexdigest()


# --- a numpy interpreter for the generated CUDA eval body -------------------

_TERNARY = re.compile(r"\((\S+) \? (\S+) : (\S+)\)")


def _py(expr):
    expr = _TERNARY.sub(r"_where(\1, \2, \3)", expr)
    expr = expr.replace("&&", "&").replace("||", "|").replace("(!", "(~")
    expr = re.sub(r"\btrue\b", "_true", expr)
    expr = re.sub(r"\bfalse\b", "_false", expr)
    return expr.replace("INFINITY", "_inf").replace("NAN", "_nan")


def _nanmin(a, b):
    return np.where(a != a, a, np.where(b != b, b, np.fmin(a, b)))


def _nanmax(a, b):
    return np.where(a != a, a, np.where(b != b, b, np.fmax(a, b)))


class _Fields:
    def __init__(self, p):
        self.p = p


def run_body(src, x, y, z, P, fields=()):
    """Evaluate the ``sdf_point`` body of a generated kernel source with
    numpy, elementwise and in IEEE arithmetic, on broadcastable coordinate
    arrays ``x, y, z`` and the flat parameter array ``P`` (all one float
    dtype).  ``fields`` are the field inputs a placeholder statement reads
    at the point's own index: arrays of the points' full broadcast shape.  The CUDA kernel itself only runs on the card; this checks on
    the CPU that the recorded statements compute what the expression's
    torch code computes."""
    dt = P.dtype.type
    start = src.index("sdf_point(")
    body = src[src.index("{", start) + 1: src.index("\n}", start)]
    env = {
        "x": x, "y": y, "z": z, "P": P, "T": dt,
        "F": _Fields(list(fields)), "fi": Ellipsis,
        "_where": np.where, "_true": np.True_, "_false": np.False_,
        "_inf": np.inf, "_nan": np.nan,
        "op_min": _nanmin, "op_max": _nanmax, "op_sqrt": np.sqrt,
        "op_abs": np.abs, "op_cos": np.cos, "op_sin": np.sin,
        "op_atan2": np.arctan2, "op_round": np.rint, "op_fmod": np.fmod,
        "op_pow": np.power, "op_exp2": np.exp2, "op_sign": np.sign,
    }
    with np.errstate(all="ignore"):
        for line in body.strip().splitlines():
            line = line.strip()
            if line.startswith("return "):
                return np.asarray(eval(_py(line[7:-1]), env), dtype=dt)
            m = re.match(r"const (?:T|bool) (v\d+) = (.*);$", line)
            env[m.group(1)] = eval(_py(m.group(2)), env)
    raise ValueError("no return statement in the generated body")


# --- gather-bearing models, built from seed-made inputs in either package ---


def polygon_points(seed=0, n=9):
    """A star-shaped polygon of ``n`` seed-made vertices, counter-clockwise:
    (n, 2) float64."""
    rng = np.random.default_rng(seed)
    ang = np.sort(rng.uniform(0.0, 2 * np.pi, n))
    return np.stack([np.cos(ang), np.sin(ang)], 1) * rng.uniform(0.55, 1.0,
                                                                 (n, 1))


def polygon_model(m, seed=0):
    """A seed-made polygon extruded and unioned with a rounded box, in the
    package ``m``."""
    return (m.polygon(polygon_points(seed)).extrude(0.6)
            | m.rounded_box((0.5, 0.5, 1.0), 0.1))


def legacy_closure(m, numpy_only=True):
    """A reference-style custom SDF in the package ``m``: a bare closure
    over (N, 3) arrays.  With ``numpy_only`` it converts the points with
    ``np.asarray``, which only numpy runs (the host tier); else plain
    indexing and arithmetic (the tier that takes the points as they
    are)."""
    @m.sdf3
    def blob(r=0.8):
        if numpy_only:
            def f(p):
                a = np.asarray(p, dtype=np.float64)
                return np.sqrt(np.sum(a * a, axis=1)) - r
        else:
            def f(p):
                return (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
                        + p[:, 2] * p[:, 2]) - r * r
        return f

    return blob()


def sphere_mesh_points():
    """An icosphere of radius 1 subdivided twice: (points (162, 3),
    triangles (320, 3)), made with numpy (closed, outward)."""
    t = (1 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
         (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
         (-t, 0, -1), (-t, 0, 1)]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    pts = [np.asarray(p, float) / np.linalg.norm(p) for p in v]
    for _ in range(2):
        mid = {}
        faces = []

        def middle(i, j):
            key = (min(i, j), max(i, j))
            if key not in mid:
                p = pts[i] + pts[j]
                pts.append(p / np.linalg.norm(p))
                mid[key] = len(pts) - 1
            return mid[key]

        for a, b, c in f:
            ab, bc, ca = middle(a, b), middle(b, c), middle(c, a)
            faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        f = faces
    return np.asarray(pts), np.asarray(f, np.int64)
