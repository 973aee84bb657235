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


def bench_models(m):
    """The benchmark's configurations (``gpubench/configs``) built with the
    package ``m``: ``[(name, expression)]`` at each script's own values
    (``knurling``, ``blobby``) and at each of the 16 factor rows of their
    edit traffic (``knurling.0`` ...), unjittered."""
    import importlib.util
    import json
    from pathlib import Path

    bench = Path(__file__).resolve().parent.parent / "gpubench"

    def load(path):
        spec = importlib.util.spec_from_file_location(
            "bench_" + path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    traffic = load(bench / "traffic.py")
    spec = json.loads((bench / "traffic" / "edit_2p22.json").read_text())
    out = []
    for name in ("knurling", "blobby"):
        config = json.loads((bench / "configs" / (name + ".json")).read_text())
        build = load(bench / "configs" / (name + ".py")).build
        t = traffic.Traffic(spec, config, 0)
        out.append((name, build(m, t.nominal)))
        for i, row in enumerate(t.rows):
            v = dict(t.nominal)
            v.update({k: t.nominal[k] * float(f) for k, f in zip(t.keys, row)})
            out.append(("%s.%d" % (name, i), build(m, v)))
    return out


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


# --- elementwise forms of the eval body, for the card tests ----------------


def elementwise_forms():
    """name -> fn(x, y, z) applying one form the recorder emits beyond the
    first twelve ops (chip_smoke.py phase 22 holds the same list)."""
    import torch

    t = lambda x, y, z: x * y + z
    u = lambda x, y, z: y - z
    forms = {name: (lambda x, y, z, f=getattr(torch, name): f(t(x, y, z)))
             for name in ("tanh", "exp", "expm1", "log", "log1p", "log2",
                          "tan", "atan", "asin", "acos", "sinh", "cosh",
                          "floor", "ceil", "trunc", "square", "rsqrt",
                          "reciprocal", "exp2")}
    forms.update({name: (lambda x, y, z, f=getattr(torch, name):
                         f(t(x, y, z), u(x, y, z)))
                  for name in ("hypot", "remainder", "floor_divide")})
    forms.update({
        "lerp": lambda x, y, z: torch.lerp(x, y, z),
        "lerp(w=0.7)": lambda x, y, z: torch.lerp(x, y, 0.7),
        "t % 0.7": lambda x, y, z: t(x, y, z) % 0.7,
        "3 % t": lambda x, y, z: 3.0 % t(x, y, z),
        "t // 0.7": lambda x, y, z: t(x, y, z) // 0.7,
        "t // 0": lambda x, y, z: t(x, y, z) // 0.0,
        "3 // t": lambda x, y, z: 3.0 // t(x, y, z),
        "2 ** t": lambda x, y, z: 2.0 ** t(x, y, z),
        "t ** -0.5": lambda x, y, z: t(x, y, z) ** -0.5,
        "t ** 0": lambda x, y, z: t(x, y, z) ** 0,
    })
    return forms


def pow_forms():
    """name -> fn(x, y, z): the general powers, which have a form in a
    float32 body only (chip_smoke.py phase 22 holds the same list)."""
    import torch

    t = lambda x, y, z: x * y + z
    u = lambda x, y, z: y - z
    return {"t ** 1.5": lambda x, y, z: t(x, y, z) ** 1.5,
            "t ** 4": lambda x, y, z: t(x, y, z) ** 4,
            "t ** -3": lambda x, y, z: t(x, y, z) ** -3,
            "pow(t, u)": lambda x, y, z: torch.pow(t(x, y, z), u(x, y, z)),
            "3 ** t": lambda x, y, z: 3.0 ** t(x, y, z),
            "t.pow(0.25)": lambda x, y, z: t(x, y, z).pow(0.25)}


def form_model(m, fn):
    """A node of package ``m`` whose own function is ``fn(x, y, z)``."""
    return m.SDF3(lambda q, p, fn=fn: fn(*p), {})


def blob(m, op, k=0.5):
    """``op(x*x + y*y + z*z) - k`` as an @sdf3 builder's node of ``m``."""

    @m.sdf3
    def build(k=k):
        def fn(q, p):
            x, y, z = p
            return op(x * x + y * y + z * z) - q["k"]

        return fn, {"k": np.float64(k)}

    return build()


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


def _remainder(a, b):
    m = np.fmod(a, b)
    return np.where((m != 0) & ((b < 0) != (m < 0)), m + b, m)


def _floor_of_quotient(div, a_over_b):
    fl = np.floor(div)
    fl = np.where(div - fl > 0.5, fl + 1, fl)
    return np.where(div == 0, np.copysign(0 * div, a_over_b), fl)


def _floordiv(a, b, inv=False):
    m = np.fmod(a, b)
    div = (a - m) * (1 / b) if inv else (a - m) / b
    div = np.where((m != 0) & ((b < 0) != (m < 0)), div - 1, div)
    q = a * (1 / b) if inv else a / b
    return np.where(b == 0, a / b, _floor_of_quotient(div, q))


def _lerp(a, b, w):
    return np.where(np.abs(w) < 0.5, a + w * (b - a), b - (b - a) * (1 - w))


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
        "op_tanh": np.tanh, "op_exp": np.exp, "op_expm1": np.expm1,
        "op_log": np.log, "op_log1p": np.log1p, "op_log2": np.log2,
        "op_tan": np.tan, "op_atan": np.arctan, "op_asin": np.arcsin,
        "op_acos": np.arccos, "op_sinh": np.sinh, "op_cosh": np.cosh,
        "op_floor": np.floor, "op_ceil": np.ceil, "op_trunc": np.trunc,
        "op_rsqrt": lambda a: 1 / np.sqrt(a), "op_hypot": np.hypot,
        "op_remainder": _remainder, "op_floordiv": _floordiv,
        "op_floordiv_number": lambda a, b: _floordiv(a, b, inv=True),
        "op_lerp": _lerp,
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


# --- ranks of torch.distributed, spawned by the sharded tests ---------------
#
# The rank bodies live here because a spawned process imports the module of
# the function it runs: this one imports only numpy at the top, so no rank
# loads JAX.  Each body writes what the parent test compares into
# ``outdir`` (rank 0, with pickle).


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, world, outdir, *args, timeout=300):
    """Run ``fn(rank, world, outdir, *args)`` in ``world`` spawned processes
    and return rank 0's pickled results (``outdir/results.pkl``).  A rank's
    exception fails the call; so does the timeout (every rank is killed)."""
    import pickle
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=(world, str(outdir)) + tuple(args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("ranks did not finish in %d s" % timeout)
    with open("%s/results.pkl" % outdir, "rb") as fp:
        return pickle.load(fp)


def _join(rank, world, outdir):
    """Join the gloo group of a test through a ``file://`` store under
    ``outdir``; one thread a rank."""
    import datetime

    import torch

    from sdf_torch import parallel

    torch.set_num_threads(1)
    return parallel.initialize(
        backend="gloo", init_method="file://%s/store" % outdir, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))


def _finish(rank, outdir, results):
    import pickle
    import sys

    import torch.distributed as dist

    assert not [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "sdf_tpu"))], "a rank imported JAX"
    if rank == 0:
        with open("%s/results.pkl" % outdir, "wb") as fp:
            pickle.dump(results, fp)
    dist.destroy_process_group()


def canon(points):
    """A triangle soup sorted by triangle, unrounded: equal soups in any
    triangle order give equal arrays."""
    tris = np.asarray(points, np.float64).reshape(-1, 9)
    return tris[np.lexsort(tris.T[::-1])]


SHARD_TILE = 8
SHARD_BOUNDS = ((-1.6, -1.6, -1.6), (1.6, 1.6, 1.6))
TWO_SPHERES_RES = 14
TWO_SPHERES_CAP = 600


def shard_grid():
    """The sharded tests' grid, about 2^14 samples: axes of 25, 26 and 27
    samples (27 z samples are 26 cells: 7 a slab over 4 ranks and 6 over 5,
    both with padded cells), and a seeded cull mask of 8-cell tiles."""
    X = np.arange(-1.6, 1.6, 0.13)
    Y = np.arange(-1.55, 1.6, 0.125)
    Z = np.arange(-1.62, 1.6, 0.122)
    shape = tuple(-(-len(a) // SHARD_TILE) for a in (X, Y, Z))
    skip = np.random.default_rng(3).random(shape) < 0.2
    return X, Y, Z, skip


def few_tiles_skip(shape):
    """A cull mask that keeps three tiles: fewer than the ranks."""
    skip = np.ones(shape, bool)
    skip[1, 1, 1] = skip[1, 2, 1] = skip[2, 1, 2] = False
    return skip


def two_spheres(m):
    """Two spheres joined by a smooth union: no exact ties in its field."""
    return m.sphere(0.6, center=(-0.3, 0.0, 0.0)).union(
        m.sphere(0.5, center=(0.35, 0.1, 0.0)), k=0.2)


def fit_inputs(dtype):
    """The fit steps' 1,024 seeded points in ``dtype``."""
    pts = np.random.default_rng(2).uniform(-1.5, 1.5, (1024, 3)).astype(dtype)
    return pts


def chamfer_cloud(seed=11, n=384, r=1.2):
    d = np.random.RandomState(seed).normal(size=(n, 3))
    return r * d / np.linalg.norm(d, axis=1, keepdims=True)


def parallel_rank(rank, world, outdir):
    """The cases of tests/test_torch_parallel.py on one rank of ``world``
    (5): meshes over the 5 ranks, over ranks 0-3, and of one rank each."""
    import warnings

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import sdf_torch as sp
    from sdf_torch import parallel
    from sdf_torch.core import diffmesh, engine
    from sdf_torch.core.node import cast, tree_leaves
    from sdf_torch.models import fit
    from sdf_torch.parallel import multihost

    _join(rank, world, outdir)
    f64 = torch.float64
    mesh5 = parallel.make_mesh("cpu")
    mesh4 = DeviceMesh("cpu", [0, 1, 2, 3], mesh_dim_names=("grid",))
    mine, _ = dist.new_subgroups(group_size=1)
    mesh1 = DeviceMesh.from_group(mine, "cpu", mesh_dim_names=("grid",))
    in4 = rank < 4
    out = {}
    X, Y, Z, skip = shard_grid()
    ex = example(sp)

    def keep(key, value):
        if rank == 0:
            out[key] = value

    # The z slabs and the tile list, 4 and 5 ranks against one.
    for variant in ("lewiner", "default"):
        for name, mesh, run, tile in (
                ("grid4", mesh4, parallel.mesh_and_march, SHARD_TILE),
                ("grid5", mesh5, parallel.mesh_and_march, SHARD_TILE),
                ("tiles4", mesh4, parallel.mesh_sparse_tiles_sharded,
                 SHARD_TILE),
                ("tiles5", mesh5, parallel.mesh_sparse_tiles_sharded,
                 SHARD_TILE)):
            if mesh is mesh4 and not in4:
                continue
            pts, pt = run(ex, X, Y, Z, skip, tile, mesh, f64, "cpu",
                          variant=variant)
            (v, fc), pt2 = run(ex, X, Y, Z, skip, tile, mesh, f64, "cpu",
                               return_indexed=True, variant=variant)
            assert np.array_equal(v[fc.reshape(-1)], pts)
            assert np.array_equal(pt, pt2)
            full = parallel.gather_triangles(pts, mesh)
            keep((name, variant), (full, pt, len(pts)))
        if rank == 0:
            for run, name in ((parallel.mesh_and_march, "grid1"),
                              (parallel.mesh_sparse_tiles_sharded, "tiles1")):
                out[(name, variant)] = run(ex, X, Y, Z, skip, SHARD_TILE,
                                           None, f64, "cpu", variant=variant)

    # Fewer live tiles than ranks: a rank with no live row.
    few = few_tiles_skip(skip.shape)
    for name, mesh in (("few4", mesh4), ("few5", mesh5)):
        if mesh is mesh4 and not in4:
            continue
        pts, pt = parallel.mesh_sparse_tiles_sharded(
            ex, X, Y, Z, few, SHARD_TILE, mesh, f64, "cpu", variant="lewiner")
        keep(name, (parallel.gather_triangles(pts, mesh), pt, len(pts)))

    # The certificate of MULTICHIP_r05.json: 1 rank vs 4, float32.
    C = np.arange(-1.2, 1.2, 0.15)
    none = np.zeros((1, 1, 1), bool)
    for variant in ("lewiner", "default"):
        for name, run, tile in (("cert", parallel.mesh_and_march, 32),
                                ("cert_tiles",
                                 parallel.mesh_sparse_tiles_sharded, 16)):
            if in4:
                pts, _ = run(ex, C, C, C, none, tile, mesh4, torch.float32,
                             "cpu", variant=variant)
                full = parallel.gather_triangles(pts, mesh4)
            if rank == 0:
                one, _ = run(ex, C, C, C, none, tile, None, torch.float32,
                             "cpu", variant=variant)
                out[(name, variant)] = (full, one)

    # generate(): non-dividing slabs over 5 ranks, the empty result, the
    # auto-mesh, output="mesh", the tiles, a mesh of one rank.
    kw = dict(step=0.09, bounds=((-1.1,) * 3, (1.1,) * 3), verbose=False,
              dtype=f64, device="cpu")
    pts = sp.generate(sp.sphere(1), mesh=mesh5, **kw)
    keep("nondiv", (parallel.gather_triangles(pts, mesh5),
                    dict(engine.LAST_STATS)))
    for sparse in (False, "tiles"):
        empty = sp.generate(sp.sphere(1), bounds=((2.0,) * 3, (3.0,) * 3),
                            step=0.1, verbose=False, sparse=sparse,
                            mesh=mesh5, device="cpu")
        assert empty.shape == (0, 3), empty.shape
    pts, pt = parallel.mesh_sparse_tiles_sharded(
        ex, X, Y, Z, np.ones_like(skip), SHARD_TILE, mesh5, f64, "cpu")
    assert pts.shape == (0, 3) and not pt.any()
    gk = dict(samples=2**14, verbose=False, dtype=f64, device="cpu")
    auto = sp.generate(ex, **gk)
    keep("auto", (parallel.gather_triangles(auto, mesh5),
                  "mesh_and_march" in engine.LAST_STATS))
    explicit = sp.generate(ex, mesh=mesh5, **gk)
    assert np.array_equal(auto, explicit)
    if in4:
        pts = sp.generate(ex, mesh=mesh4, **gk)
        stats = dict(engine.LAST_STATS)
        v, fc = sp.generate(ex, mesh=mesh4, output="mesh", **gk)
        tiles = sp.generate(ex, mesh=mesh4, sparse="tiles", **gk)
        tstats = dict(engine.LAST_STATS)
        keep("engine4", (parallel.gather_triangles(pts, mesh4), stats,
                         parallel.gather_triangles(v[fc.reshape(-1)], mesh4),
                         parallel.gather_triangles(tiles, mesh4), tstats))
        # A gather-bearing expression: B1 reads its fields on each slab,
        # B7 records them on each rank's tiles.
        g = gather_models(sp)["rotated"]
        shares = [parallel.gather_triangles(
            sp.generate(g, samples=2**13, verbose=False, sparse=s,
                        mesh=mesh4, device="cpu"), mesh4)
            for s in (False, "tiles")]
        keep("gather4", shares)
    keep("one", sp.generate(ex, mesh=mesh1, **gk))
    if rank == 0:
        out["gather1"] = [
            sp.generate(gather_models(sp)["rotated"], samples=2**13,
                        verbose=False, sparse=s, mesh=mesh1, device="cpu")
            for s in (False, "tiles")]

    # diffmesh.extract_sharded on 4 ranks: values, and the gradients of a
    # loss every rank computes from the gathered triangles.
    w = torch.tensor([1.0, 2.0, 3.0], dtype=f64)
    if in4:
        for dtype in (torch.float32, f64):
            node = cast(two_spheres(sp), dtype, "cpu")
            leaves = [x.requires_grad_(True) for x in tree_leaves(node)]
            verts, n, valid = diffmesh.extract_sharded(
                node, SHARD_BOUNDS, TWO_SPHERES_RES, TWO_SPHERES_CAP, dtype,
                mesh=mesh4, device="cpu")
            wv = valid.to(dtype)[:, None, None]
            mv = (verts * wv).sum(dim=(0, 1)) / (3.0 * valid.sum())
            grads = torch.autograd.grad((mv * w.to(dtype)).sum(), leaves)
            flat = torch.cat([g.reshape(-1) for g in grads]).numpy()
            every = multihost.all_gather_host(flat, mesh4.get_group())
            assert (every == every[0]).all(), "ranks' gradients differ"
            keep(("extract", str(dtype)), (
                verts.detach().numpy(), int(n), valid.numpy(),
                [g.numpy() for g in grads]))
    if rank == 0:
        for dtype in (torch.float32, f64):
            node = cast(two_spheres(sp), dtype, "cpu")
            leaves = [x.requires_grad_(True) for x in tree_leaves(node)]
            verts, n, valid = diffmesh.extract(
                node, SHARD_BOUNDS, TWO_SPHERES_RES, TWO_SPHERES_CAP, dtype,
                device="cpu")
            mv = diffmesh.mean_vertex(node, SHARD_BOUNDS, TWO_SPHERES_RES,
                                      TWO_SPHERES_CAP, dtype, device="cpu")
            grads = torch.autograd.grad((mv * w.to(dtype)).sum(), leaves)
            out[("extract1", str(dtype))] = (
                verts.detach().numpy(), int(n), valid.numpy(),
                [g.numpy() for g in grads])

    # The sharded fit step, fit(mesh=) and one fit_chamfer(mesh=) step.
    if in4:
        step = fit.make_sharded_fit_step(mesh4)
        for dtype in ("float32", "float64"):
            pts = torch.as_tensor(fit_inputs(dtype))
            tgt = example(sp)(pts, device="cpu")[:, 0].detach()
            node, loss = step(sp.sphere(0.8), pts, tgt, 0.01)
            got = [x.detach().numpy() for x in tree_leaves(node)]
            flat = np.concatenate([g.reshape(-1) for g in got])
            every = multihost.all_gather_host(flat, mesh4.get_group())
            assert (every == every[0]).all(), "ranks' leaves differ"
            assert all(x.is_leaf and x.requires_grad
                       for x in tree_leaves(node))
            keep(("fit", dtype), (float(loss), got))
        try:
            step(sp.sphere(0.8), pts[:1022], tgt[:1022], 0.01)
            raised = False
        except ValueError:
            raised = True
        keep("fit_odd_batch_raises", raised)
        pts = np.random.default_rng(1).uniform(-2, 2, (1023, 3))
        node, loss = fit.fit(sp.sphere(0.5), sp.sphere(1.3), pts, steps=3,
                             lr=0.1, dtype=f64, mesh=mesh4, device="cpu")
        keep("fit_mesh", (loss, [x.detach().numpy()
                                 for x in tree_leaves(node)]))
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # no overflow at this capacity
            node, loss = fit.fit_chamfer(
                sp.sphere(1.0), chamfer_cloud(), SHARD_BOUNDS, steps=1,
                lr=0.05, resolution=20, dtype=f64, mesh=mesh4, device="cpu")
        keep("chamfer", (loss, [x.detach().numpy()
                                for x in tree_leaves(node)]))
    _finish(rank, outdir, out)


def multihost_rank(rank, world, outdir, port):
    """The cases of tests/test_torch_multihost.py on one of 2 ranks that
    join as torchrun's ranks do, from the environment."""
    import os

    import torch
    import torch.distributed as dist

    import sdf_torch as sp
    from sdf_torch import parallel
    from sdf_torch.io import stl
    from sdf_torch.parallel import multihost

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    got = parallel.initialize(backend="gloo")
    assert got == (rank, world), got
    writes = []
    real = stl.write_binary_stl
    stl.write_binary_stl = lambda *a: writes.append(a[0]) or real(*a)
    kw = dict(samples=2**14, verbose=False, dtype=np.float64, device="cpu",
              bounds=((-1.1,) * 3, (1.1,) * 3))
    share = sp.generate(sp.sphere(1), **kw)  # the auto-mesh of the world
    full = parallel.gather_triangles(share)
    parallel.write_on_process0("%s/gathered.stl" % outdir, full)
    saved = sp.save("%s/saved.stl" % outdir, sp.sphere(1), **kw)
    counts = multihost.all_gather_host(
        np.asarray([len(share), len(writes)]), dist.group.WORLD)
    _finish(rank, outdir, {"share": share, "full": full, "saved": saved,
                           "counts": counts})


def cuda_rank(rank, world, outdir):
    """tests/test_torch_cuda.py's sharded case on one of ``world`` gloo
    ranks that share card 0: the example's z slabs and tile list at 2^18,
    float32, and each rank's kernel launches."""
    import torch

    import sdf_torch as sp
    from sdf_torch import parallel
    from sdf_torch.core import compact, eval_classify, mc, mc33

    _join(rank, world, outdir)
    mesh = parallel.make_mesh()
    wrappers = [eval_classify.eval_and_classify, mc33.classify_ext,
                mc.ntri_of, compact.indices_of,
                compact.indices_and_ranktable_of,
                eval_classify.eval_tiles_and_classify_batched]
    out = {}
    for sparse in (False, "tiles"):
        before = [w.launches for w in wrappers]
        share = sp.generate(example(sp), samples=2**18, verbose=False,
                            sparse=sparse, mesh=mesh)
        launched = [w.launches - b for w, b in zip(wrappers, before)]
        out[sparse] = (parallel.gather_triangles(share, mesh), launched,
                       torch.cuda.current_device())
    _finish(rank, outdir, out)
