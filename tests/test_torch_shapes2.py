"""The 2D DSL (``sdf_torch.ops.shapes2``) against ``sdf_tpu.ops.shapes2``.

The same seeded points go through both packages; the JAX expression is
evaluated EAGERLY (op by op, under ``jax.disable_jit``: the polygon's
``lax.fori_loop`` is otherwise compiled, and XLA contracts its
multiply-adds into FMAs), as in tests/test_torch_ops.py.

Tolerances:
  * float64: bit-equal (every op uses + - * / sqrt min max abs where sign,
    and the construction-time sin and cos are numpy's in both packages),
    the polygon's loop over its edges included.
  * float32: |diff| <= 8 eps32 (the values are of order one).  The port
    keeps every constant a Python float, which rounds to float32 like a
    weak JAX literal; the reference's ``hexagon`` multiplies by numpy
    float64 scalars, which JAX does not weaken, so it computes part of its
    arithmetic in float64 and rounds once at the end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
import sdf_torch as sp
from sdf_tpu.core.node import Points as JPoints
from sdf_tpu.core.node import cast as jcast
from sdf_torch.core import eval_classify as ec
from sdf_torch.core import hybrid
from sdf_torch.core.node import Points as TPoints
from sdf_torch.core.node import cast as tcast

import torch_helpers as th

CASES2 = {
    "circle": lambda m: m.circle(0.7, center=(0.1, -0.2)),
    "line": lambda m: m.d2.line((1, 2), (0.1, 0.0)),
    "slab": lambda m: m.d2.slab(x0=-0.5, y1=0.4, y0=-0.3),
    "rectangle": lambda m: m.rectangle((1.0, 0.6), center=(0.1, 0.0)),
    "rectangle_ab": lambda m: m.rectangle(a=(-0.5, -0.4), b=(0.5, 0.3)),
    "rounded_rectangle": lambda m: m.rounded_rectangle(
        (1.2, 0.8), (0.1, 0.2, 0.05, 0.3)),
    "equilateral_triangle": lambda m: m.equilateral_triangle(),
    "hexagon": lambda m: m.hexagon(0.8),
    "rounded_x": lambda m: m.rounded_x(0.9, 0.1),
    "polygon": lambda m: m.polygon(th.polygon_points(0)),
    "vesica": lambda m: m.vesica(0.8, 0.3),
    "translate": lambda m: m.circle(0.5).translate((0.2, -0.1)),
    "scale": lambda m: m.hexagon(0.5).scale((1.5, 0.7)),
    "rotate": lambda m: m.rectangle((1.0, 0.4)).rotate(0.4),
    "circular_array": lambda m: m.circle(0.2).translate((0.6, 0)).circular_array(5),
    "elongate": lambda m: m.circle(0.3).elongate((0.2, 0.1)),
    "union_k": lambda m: m.circle(0.5).union(m.rectangle(0.7), k=0.1),
    "difference": lambda m: m.rectangle(1.0) - m.circle(0.4),
    "intersection": lambda m: m.hexagon(0.9) & m.circle(0.8),
    "shell": lambda m: m.circle(0.6).shell(0.1),
    "repeat": lambda m: m.circle(0.1).repeat(0.3, count=2, padding=1),
}

CASES3 = {
    "extrude": lambda m: m.hexagon(0.8).extrude(0.6),
    "extrude_to": lambda m: m.circle(0.6).extrude_to(
        m.rectangle(0.8), 1.0, m.ease.in_out_quad),
    "revolve": lambda m: m.rounded_x(0.5, 0.1).revolve(0.6),
    "extrude_polygon": lambda m: m.polygon(th.polygon_points(1)).extrude(0.5),
    "revolve_vesica": lambda m: m.vesica(0.6, 0.2).revolve(0.3),
    "mixed": lambda m: (m.equilateral_triangle().extrude(0.4)
                        | m.rounded_rectangle((0.8, 0.5), 0.1).extrude(1.0)
                        .translate((0.3, 0, 0))),
}

GATHER_FREE3 = [k for k in CASES3 if "polygon" not in k]


def _points(dim, seed=0, n=4096):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, (n, dim))


def _jax_eval(f, pts, dtype):
    fc = jcast(f, dtype)
    with jax.disable_jit():
        d = fc(JPoints(*[jnp.asarray(pts[:, i], dtype)
                         for i in range(pts.shape[1])]))
    return np.asarray(jnp.broadcast_to(d, (len(pts),)))


def _torch_eval(f, pts, dtype):
    fc = tcast(f, dtype, "cpu")
    d = fc(TPoints(*[torch.as_tensor(pts[:, i], dtype=dtype)
                     for i in range(pts.shape[1])]))
    return torch.as_tensor(d).broadcast_to((len(pts),)).numpy()


def _compare(build, dim, dtype):
    pts = _points(dim)
    a = _jax_eval(build(st), pts, getattr(jnp, dtype))
    b = _torch_eval(build(sp), pts, getattr(torch, dtype))
    assert a.shape == b.shape
    if dtype == "float64":
        np.testing.assert_array_equal(b, a)
    else:
        np.testing.assert_allclose(b, a.astype(np.float32), rtol=0,
                                   atol=8 * np.finfo(np.float32).eps)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(CASES2))
def test_2d_field_matches_jax(name, dtype):
    _compare(CASES2[name], 2, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(CASES3))
def test_lift_to_3d_matches_jax(name, dtype):
    _compare(CASES3[name], 3, dtype)


@pytest.mark.parametrize("name", GATHER_FREE3)
def test_generated_body_on_grid(name):
    """The kernel body generated for a gather-free 2D model lifted to 3D,
    interpreted with numpy over a grid, equals the plain volume bit for bit
    in both dtypes."""
    f = CASES3[name](sp)
    assert not hybrid.count_gathers(f)
    X = np.linspace(-1.1, 1.1, 13)
    Y = np.linspace(-1.05, 1.15, 11)
    Z = np.linspace(-0.8, 0.9, 9)
    src = ec.kernel_source(f)
    for td, nd in ((torch.float32, np.float32), (torch.float64, np.float64)):
        vt, _ = ec.eval_and_classify(f, X, Y, Z, td, "cpu")
        P = ec._flat_params(f, td, "cpu").numpy()
        x, y, z = (a.astype(nd) for a in (X, Y, Z))
        got = th.run_body(src, x[:, None, None], y[None, :, None],
                          z[None, None, :], P)
        np.testing.assert_array_equal(np.broadcast_to(got, vt.shape),
                                      vt.numpy())


def test_polygon_is_a_gather_and_bit_equal_in_float64():
    """polygon is gather-marked (its edge loop has no statement form), so
    its field is recorded ahead; on a dense grid it is bit-equal to the JAX
    package's eager evaluation in float64."""
    f = sp.polygon(th.polygon_points(2, 13))
    assert hybrid.count_gathers(f) == 1
    assert hybrid.count_gathers(f.extrude(1.0) | sp.sphere(0.5)) == 1
    g = np.linspace(-1.1, 1.1, 64)
    pts = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    a = _jax_eval(st.polygon(th.polygon_points(2, 13)), pts, jnp.float64)
    b = _torch_eval(f, pts, torch.float64)
    np.testing.assert_array_equal(b, a)
    assert (b < 0).any() and (b > 0).any()


def test_public_2d_call_contract():
    """(N, 2) -> (N, 1), including the N == dim padding case."""
    for n in (2, 5):
        pts = _points(2, seed=3, n=n)
        a = np.asarray(st.rounded_x(0.9, 0.1)(jnp.asarray(pts)))
        b = sp.rounded_x(0.9, 0.1)(torch.as_tensor(pts)).numpy()
        assert b.shape == (n, 1)
        np.testing.assert_array_equal(b, a)


def test_star_exports_match_the_reference():
    """The port exports every public name of the JAX package, the slice
    functions included."""
    missing = {n for n in dir(st) if not n.startswith("_")} - set(dir(sp))
    assert missing <= {"enable_compile_cache",
                       "engine", "core", "ops", "parallel", "models",
                       "io", "utils"}, missing
    assert callable(sp.sample_slice) and callable(sp.show_slice)
    for name in ("SDF2", "circle", "polygon", "extrude", "revolve", "Mesh",
                 "mesh", "d2", "text", "image", "measure_text",
                 "measure_image"):
        assert hasattr(sp, name), name
