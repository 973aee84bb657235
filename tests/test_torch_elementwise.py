"""Elementwise expressions in a user's ``@sdf3``: the recorder's op forms
(``core/eval_classify.py``, ``csrc/sdf_point.cuh``) and the automatic field
route (``core/hybrid.route_fields``), sdf_torch (device="cpu") against
sdf_tpu on JAX-CPU.

The model is ``op(x*x + y*y + z*z) - k`` (or ``op`` of a shifted or
scaled argument, so that the surface lies inside the bounds +-2), built in
each package with its own op.

Tolerances:
  * triangle counts: within max(8, 1e-3 x the reference's) in float32 and
    float64.  torch on the CPU computes transcendentals with SLEEF and XLA
    with its own approximations, and jitted XLA contracts x*x + y*y into
    an FMA; either can move a sample across zero, a cell's case with it.
    ``chip_smoke.py`` phase 22 holds the card to the same tolerance
    against the port's device="cpu" run.
  * float64 soups where the counts are equal: the same triangles within
    1e-9 (a vertex moves by the field's relative error over its slope).
  * C4's three models at 2**15: the reference's counts exactly (1,304 /
    1,304 / 1,640).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
import sdf_torch as sp
from sdf_tpu.parallel import grid as pgrid
from sdf_torch.core import engine as tengine
from sdf_torch.core import eval_classify as ec
from sdf_torch.core import hybrid
from sdf_torch.core import node as tnode
from sdf_torch.utils import checkpoint as tckpt

import torch_helpers as th

BOUNDS = ((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0))
COUNT_RTOL, COUNT_ATOL = 1e-3, 8
SOUP_ATOL = 1e-9

# name -> (torch op, jnp op, k, the op form in the kernel source or None
# for a form that routes as a field); the model is op(r2) - k.
FORMS = {
    "tanh": (torch.tanh, jnp.tanh, 0.5, "op_tanh("),
    "atan": (torch.atan, jnp.arctan, 0.5, "op_atan("),
    "exp(-t)": (lambda t: torch.exp(-t), lambda t: jnp.exp(-t), 0.5,
                "op_exp("),
    "expm1": (torch.expm1, jnp.expm1, 1.0, "op_expm1("),
    "log": (lambda t: torch.log(t + 0.25), lambda t: jnp.log(t + 0.25), 0.2,
            "op_log("),
    "log1p": (torch.log1p, jnp.log1p, 0.5, "op_log1p("),
    "log2": (lambda t: torch.log2(t + 0.25), lambda t: jnp.log2(t + 0.25),
             0.3, "op_log2("),
    "tan": (lambda t: torch.tan(t * 0.25), lambda t: jnp.tan(t * 0.25), 0.5,
            "op_tan("),
    "asin": (lambda t: torch.asin(t * 0.08), lambda t: jnp.arcsin(t * 0.08),
             0.1, "op_asin("),
    "acos": (lambda t: torch.acos(t * 0.08), lambda t: jnp.arccos(t * 0.08),
             1.4, "op_acos("),
    "sinh": (torch.sinh, jnp.sinh, 1.0, "op_sinh("),
    "cosh": (torch.cosh, jnp.cosh, 1.5, "op_cosh("),
    "floor": (torch.floor, jnp.floor, 0.5, "op_floor("),
    "ceil": (torch.ceil, jnp.ceil, 1.5, "op_ceil("),
    "trunc": (lambda t: torch.trunc(t - 1.5), lambda t: jnp.trunc(t - 1.5),
              -0.5, "op_trunc("),
    "square": (torch.square, jnp.square, 1.0, None),
    "rsqrt": (lambda t: -torch.rsqrt(t + 0.25),
              lambda t: -jax.lax.rsqrt(t + 0.25), -0.8, "op_rsqrt("),
    "reciprocal": (lambda t: -torch.reciprocal(t + 0.25),
                   lambda t: -jnp.reciprocal(t + 0.25), -0.8, None),
    "exp2": (torch.exp2, jnp.exp2, 2.0, "op_exp2("),
    "hypot": (lambda t: torch.hypot(t, t * 0.5),
              lambda t: jnp.hypot(t, t * 0.5), 1.0, "op_hypot("),
    "t % 3": (lambda t: t % 3.0, lambda t: t % 3.0, 0.5, "op_remainder("),
    "remainder": (lambda t: torch.remainder(t, 0.7 + 0 * t),
                  lambda t: jnp.remainder(t, 0.7 + 0 * t), 0.3,
                  "op_remainder("),
    "t // 0.7": (lambda t: t // 0.7, lambda t: t // 0.7, 0.5,
                 "op_floordiv_number("),
    "floor_divide": (lambda t: torch.floor_divide(t, 0.7 + 0 * t),
                     lambda t: jnp.floor_divide(t, 0.7 + 0 * t), 0.5,
                     "op_floordiv("),
    "lerp": (lambda t: torch.lerp(t, 2 * t, 0.3),
             lambda t: t + 0.3 * (2 * t - t), 1.0, "op_lerp("),
    "2 ** t": (lambda t: 2.0 ** t, lambda t: 2.0 ** t, 2.0, "op_pow("),
    "pow(t, 1.5)": (lambda t: torch.pow(t, 1.5), lambda t: t ** 1.5, 0.5,
                    None),
}
# The forms whose op has no C++ form: the route makes their node a field.
ROUTED = {"pow(t, 1.5)": "pow"}


def _model(m, op, k):
    """``op(x*x + y*y + z*z) - k`` as an @sdf3 builder of package ``m``."""

    @m.sdf3
    def blob(k=k):
        def fn(q, p):
            x, y, z = p
            return op(x * x + y * y + z * z) - q["k"]

        return fn, {"k": np.float64(k)}

    return blob()


def _jax(f, samples, dtype):
    return np.asarray(f.generate(
        samples=samples, bounds=BOUNDS, verbose=False, dtype=dtype,
        mesh=pgrid.make_mesh(jax.devices()[:1])))


def _port(f, samples, dtype, **kw):
    return sp.generate(f, samples=samples, bounds=BOUNDS, verbose=False,
                       dtype=dtype, device="cpu", **kw)


def _close_counts(n, want):
    return abs(n - want) <= max(COUNT_ATOL, COUNT_RTOL * want)


def _assert_soups_close(got, want):
    """Two soups as sets of triangles within SOUP_ATOL: each sorted by its
    coordinates rounded to 1e-6 (vertices the packages place an ulp apart
    would reorder an unrounded sort), then compared row by row."""

    def canon(points):
        tris = np.asarray(points, np.float64).reshape(-1, 9)
        return tris[np.lexsort(np.round(tris, 6).T[::-1])]

    np.testing.assert_allclose(canon(got), canon(want), rtol=0,
                               atol=SOUP_ATOL)


@pytest.fixture(autouse=True)
def _fresh_memos():
    tengine._BOUNDS_MEMO.clear()
    tengine._COUNTS_MEMO.clear()
    tengine._SKIP_MEMO.clear()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(FORMS))
def test_form_meshes_as_the_reference(name, dtype):
    """Each form's model through the port's generate() against sdf_tpu's
    at 2**13 samples: counts within the stated tolerance; in float64 with
    equal counts, the canonical soups within 1e-9."""
    top, jop, k, _ = FORMS[name]
    want = _jax(_model(st, jop, k), 2**13, getattr(jnp, dtype))
    got = _port(_model(sp, top, k), 2**13, getattr(torch, dtype))
    n, m = len(got) // 3, len(want) // 3
    assert m > 0 and _close_counts(n, m), (n, m)
    assert np.isfinite(got).all()
    if dtype == "float64" and n == m:
        _assert_soups_close(got, want)


@pytest.mark.parametrize("name, tris", [("tanh", 1304), ("atan", 1304),
                                        ("exp(-t)", 1640)])
def test_c4_models_give_the_reference_counts(name, tris):
    """The fault's three models at 2**15 (float32, the defaults): the
    reference's triangle counts, in both packages."""
    top, jop, k, _ = FORMS[name]
    assert len(_jax(_model(st, jop, k), 2**15, jnp.float32)) // 3 == tris
    assert len(_port(_model(sp, top, k), 2**15, torch.float32)) // 3 == tris
    assert "field_route_ops" not in tengine.LAST_STATS


@pytest.mark.parametrize("name", sorted(FORMS))
def test_recorder_emits_the_form(name):
    """kernel_source records each form (or raises NoCppForm naming the op
    for a form that routes), and the generated body, interpreted with numpy,
    computes what the port's plain torch evaluation computes (within 4 ulps
    of float64 of the op's value, 1 + |k|: numpy's and SLEEF's libm
    differ)."""
    top, _, k, form = FORMS[name]
    f = _model(sp, top, k)
    if name in ROUTED:
        with pytest.raises(ec.NoCppForm, match=ROUTED[name]):
            ec.kernel_source(f)
        return
    src = ec.kernel_source(f)
    if form is not None:
        assert form in src
    x = np.linspace(-2.0, 2.0, 17)
    P = ec._flat_params(f, torch.float64, "cpu").numpy()
    got = th.run_body(src, x[:, None, None], x[None, :, None],
                      x[None, None, :], P)
    want, _ = ec._eval_classify_plain(f, x, x, x, torch.float64, "cpu")
    want = want.numpy()
    eps = np.finfo(np.float64).eps
    np.testing.assert_allclose(np.broadcast_to(got, want.shape), want,
                               rtol=4 * eps, atol=4 * eps * (1 + abs(k)))


@pytest.mark.parametrize("expr, form", [
    (lambda t: t % 3.0, "op_remainder(v"),
    (lambda t: 3.0 % t, "op_remainder(T(3.0), v"),
    (lambda t: t // 0.7, "op_floordiv_number(v"),
    (lambda t: 3.0 // t, "op_floordiv(T(3.0), v"),
    (lambda t: t // 0.0, "* (T(1) / T(0.0)))"),
    (lambda t: torch.floor_divide(t, t + 1), "op_floordiv(v"),
    (lambda t: t ** -0.5, "op_rsqrt(v"),
    (lambda t: t ** 0, "= T(1);"),
    (lambda t: torch.pow(t, 2), "* v"),
    (lambda t: 2 ** t, "op_pow(T(2.0), v"),
    (lambda t: t.tanh(), "op_tanh(v"),
    (lambda t: torch.arctan(t), "op_atan(v"),
])
def test_operators_and_methods_record(expr, form):
    """``%``, ``//`` (by a number, a zero and a tensor), the number
    exponents of ``**`` and ``torch.pow``, ``2 ** t`` and tensor methods
    record to their forms."""
    assert form in ec.kernel_source(_model(sp, expr, 0.5))


@pytest.mark.parametrize("expr, op", [
    (torch.erf, "erf"),
    (lambda t: t.erf(), "erf"),
    (lambda t: t ** 1.5, "pow"),
    (lambda t: 3.0 ** t, "pow"),
    (lambda t: torch.pow(t, t), "pow"),
    (lambda t: torch.sigmoid(t), "sigmoid"),
    (lambda t: t.where(t > 0, t * 0.5), "where"),
    (lambda t: t.round(decimals=1), "round"),
    (lambda t: torch.round(t, decimals=1), "round"),
    (lambda t: torch.exp(t, out=None), "exp"),
])
def test_missing_forms_raise_one_class_naming_the_op(expr, op):
    """An op, operator or tensor method with no form raises NoCppForm (a
    NotImplementedError) naming it, in kernel_source as in the route's
    trial; the route marks the node."""
    f = _model(sp, expr, 0.5)
    with pytest.raises(ec.NoCppForm, match=op) as info:
        ec.kernel_source(f)
    assert isinstance(info.value, NotImplementedError) and info.value.op == op
    tree, ops = hybrid.route_fields(f)
    assert ops == (op,) and hybrid.count_gathers(tree) == 1


@pytest.mark.parametrize("expr", [
    lambda t: t ** 1.5, lambda t: 3.0 ** t, lambda t: torch.pow(t, t),
    lambda t: t.pow(4), lambda t: t ** -3])
def test_general_powers_have_a_float32_form(expr):
    """A general power records as op_pow in a float32 body (the library's
    powf equals PyTorch's on the card), and raises in a float64 body or
    one for both dtypes; the route marks it in float64 only, and
    generate() names it there only."""
    f = _model(sp, expr, 0.5)
    assert "op_pow(" in ec.kernel_source(f, dtype=torch.float32)
    assert "op_pow(" in ec.tile_kernel_source(f, dtype=torch.float32)
    for dtype in (None, torch.float64):
        with pytest.raises(ec.NoCppForm, match="pow"):
            ec.kernel_source(f, dtype=dtype)
    assert hybrid.route_fields(f, dtype=torch.float32) == (f, ())
    assert hybrid.route_fields(f, dtype=torch.float64)[1] == ("pow",)
    assert hybrid.route_fields(f)[1] == ("pow",)
    _port(f, 2**12, torch.float32)
    assert "field_route_ops" not in tengine.LAST_STATS
    _port(f, 2**12, torch.float64)
    assert tengine.LAST_STATS["field_route_ops"] == ("pow",)


# The operands after the tensor itself, by method, for the methods test.
_METHOD_ARGS = {"lerp": (lambda t: t * 0.5 + 0.25, 0.3), "pow": (3,),
                "clamp": (-0.5, 0.5)}


@pytest.mark.parametrize("name", sorted(ec._METHODS))
def test_a_method_records_as_its_function(name):
    """``t.name(...)`` records the same body as ``torch.name(t, ...)``:
    each method that records takes the tensor as its function's first
    operand."""
    func = getattr(torch, name)
    arity = ec._ARITY.get(func, 1)
    rest = _METHOD_ARGS.get(name, (lambda t: t * 0.5 + 0.25,) * (arity - 1))
    if name == "logical_and":
        body = lambda c: lambda t: torch.where(c(t > 0), t, -t)
        method = body(lambda b: b.logical_and(b))
        function = body(lambda b: torch.logical_and(b, b))
    else:
        ops = lambda t: [r(t) if callable(r) else r for r in rest]
        method = lambda t: getattr(t, name)(*ops(t))
        function = lambda t: func(t, *ops(t))
    want = ec.kernel_source(_model(sp, function, 0.5))
    assert ec.kernel_source(_model(sp, method, 0.5)) == want


def test_where_method_routes_and_meshes_as_torch():
    """``t.where(c, y)`` is ``torch.where(c, t, y)``: it has no form, so
    the route makes its node a field, and the mesh equals the one of the
    same expression written with ``torch.where`` (which records)."""
    method = _model(sp, lambda t: t.where(t > 1, t * 0.5), 0.5)
    function = _model(sp, lambda t: torch.where(t > 1, t, t * 0.5), 0.5)
    tree, ops = hybrid.route_fields(method)
    assert ops == ("where",) and hybrid.count_gathers(tree) == 1
    assert "? v" in ec.kernel_source(function)
    got = _port(method, 2**13, torch.float64)
    assert tengine.LAST_STATS["field_route_ops"] == ("where",)
    want = _port(function, 2**13, torch.float64)
    assert "field_route_ops" not in tengine.LAST_STATS and len(want) > 0
    np.testing.assert_array_equal(got, want)


def _erf_under_rotate_and_union(m):
    blob = _model(m, torch.erf, 0.5)
    return blob.rotate(0.3, m.X) | m.sphere(0.4).translate((1.0, 0, 0))


def test_route_marks_the_smallest_failing_node():
    """Under a rotate and a union, only the erf node is marked: the union
    and the rotate stay in the kernel body, the sphere too, and the kernel
    source reads one field."""
    f = _erf_under_rotate_and_union(sp)
    tree, ops = hybrid.route_fields(f)
    assert ops == ("erf",) and hybrid.count_gathers(tree) == 1
    (rot,) = [c for c in hybrid._child_nodes(tree.params)
              if hybrid.count_gathers(c)]
    assert not hybrid.needs_gather(tree.fn) and not hybrid.needs_gather(rot.fn)
    (blob,) = hybrid._child_nodes(rot.params)
    assert hybrid.needs_gather(blob.fn)
    src = ec.kernel_source(hybrid.to_kernel_tree(tree), 1)
    assert "F.p[0][fi]" in src and "op_erf" not in src
    assert tree.fn is f.fn


def test_route_leaves_a_covered_model_alone():
    """A model every op of which has a form comes back as the same object,
    with no op named; so does every op case of the DSL."""
    for build, _ in list(th.op_cases().values()) + [
            (lambda m: _model(m, torch.tanh, 0.5), None)]:
        f = build(sp)
        tree, ops = hybrid.route_fields(f)
        assert tree is f and ops == ()


def test_user_errors_propagate_through_the_route():
    """A trial that fails for another reason than a missing form raises as
    kernel_source does: a bug in the user's function, and data-dependent
    Python control flow."""

    def buggy(t):
        raise ValueError("a bug in the model")

    def branchy(t):
        return t if t > 1 else -t

    with pytest.raises(ValueError, match="a bug"):
        hybrid.route_fields(_model(sp, buggy, 0.5))
    with pytest.raises(NotImplementedError, match="control flow") as info:
        hybrid.route_fields(_model(sp, branchy, 0.5))
    assert not isinstance(info.value, ec.NoCppForm)


@pytest.mark.parametrize("sparse", [False, "tiles", True])
def test_routed_generate_names_the_op_and_equals_torch(sparse):
    """generate() of the erf model on the CPU: LAST_STATS names erf and
    counts one node; the soup is bit-equal to the same expression with the
    node marked by hand (the route adds no math)."""
    got = _port(_erf_under_rotate_and_union(sp), 2**13, torch.float64,
                sparse=sparse)
    st_ = dict(tengine.LAST_STATS)
    assert st_["field_route_ops"] == ("erf",)
    assert st_["field_route_nodes"] == 1
    f = _erf_under_rotate_and_union(sp)
    blob = hybrid._child_nodes(hybrid._child_nodes(f.params)[0].params)[0]
    blob.fn.needs_gather = True
    try:
        want = _port(f, 2**13, torch.float64, sparse=sparse)
    finally:
        del blob.fn.needs_gather
    assert len(got) > 0
    np.testing.assert_array_equal(got, want)


def test_routed_model_matches_the_reference():
    """The erf model meshes as sdf_tpu's (jnp's erf) within the stated
    tolerance, float64."""
    want = _jax(_model(st, jax.scipy.special.erf, 0.5).rotate(0.3, st.X)
                | st.sphere(0.4).translate((1.0, 0, 0)), 2**13, jnp.float64)
    got = _port(_erf_under_rotate_and_union(sp), 2**13, torch.float64)
    n, m = len(got) // 3, len(want) // 3
    assert m > 0 and _close_counts(n, m)
    if n == m:
        _assert_soups_close(got, want)


def test_second_generate_of_a_routed_model_hits_the_memo(monkeypatch):
    """A rebuilt routed model has the same structure key and fingerprint:
    the second generate() fetches once instead of twice, bit-equal."""
    calls = []
    fetch = tnode.fetch
    monkeypatch.setattr(tnode, "fetch",
                        lambda *a, **k: calls.append(1) or fetch(*a, **k))
    a = hybrid.route_fields(_erf_under_rotate_and_union(sp))[0]
    b = hybrid.route_fields(_erf_under_rotate_and_union(sp))[0]
    assert tckpt.structure_key(a) == tckpt.structure_key(b)
    first = _port(_erf_under_rotate_and_union(sp), 2**13, torch.float32,
                  sparse=False)
    assert len(calls) == 2
    second = _port(_erf_under_rotate_and_union(sp), 2**13, torch.float32,
                   sparse=False)
    assert len(calls) == 3
    np.testing.assert_array_equal(second, first)


def test_a_routed_tree_passes_through(monkeypatch):
    """route_fields of a tree it returned (generate() handing its routed
    tree to a mesh function) takes no second trial and no structure key,
    returns the same tree and ops, and records them in ``stats``."""
    f = _erf_under_rotate_and_union(sp)
    tree, ops = hybrid.route_fields(f)
    plain = sp.sphere(1.0)
    same = hybrid.route_fields(plain)
    monkeypatch.setattr(hybrid.ckpt, "structure_key",
                        lambda *a: pytest.fail("a second trial"))
    stats = {}
    assert hybrid.route_fields(tree, stats) == (tree, ops)
    assert stats == {"field_route_nodes": 1, "field_route_ops": ("erf",)}
    assert hybrid.route_fields(plain, stats) == same == (plain, ())


def test_route_applies_on_the_tile_paths():
    """core.sparse.mesh_sparse_tiles routes by itself (B6/B7's caller
    outside generate()), and records the route in its stats."""
    from sdf_torch.core import sparse as tsparse

    f = _erf_under_rotate_and_union(sp)
    X = Y = Z = np.linspace(-2, 2, 33)
    skip = np.zeros((4, 4, 4), bool)
    stats = {}
    (v, faces), _ = tsparse.mesh_sparse_tiles(
        f, X, Y, Z, skip, 8, torch.float64, "cpu", stats=stats)
    assert stats["field_route_ops"] == ("erf",) and len(faces) > 0
