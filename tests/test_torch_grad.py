"""Gradients of the DSL: ``SDF3.gradient``/``normal`` and the gradient of a
field with respect to every leaf, ``sdf_torch`` against ``jax.grad`` of
``sdf_tpu``, float64.

The same seeded points go to both packages, among them points with exact
zero coordinates, the origin, and points with |x| == |y|: there ``abs``,
``minimum``/``maximum`` against a number and ``clip`` meet their ties,
where the port applies JAX's rules (abs' = 1 at 0, a tie splits 0.5).  The
leaf gradients are taken with JAX EAGER (``jax.disable_jit``): jitted XLA
contracts multiply-adds, which turns exact ties into near-ties.

Tolerances:
  * leaf gradients: rtol 1e-9, atol 1e-12 of the largest gradient of the
    case (entries that cancel to rounding noise); every leaf JAX moves,
    the port moves the same.
  * spatial gradients and normals: atol 1e-12 (values of order one), NaNs
    in the same places.
  * The knurling model's points with x == 0, y == 0 or |x| == |y| are left
    out: there its 24-sector ``circular_array`` (15 degrees a sector) sits
    exactly on a sector edge, where the last ulp of ``atan2`` (XLA's and
    PyTorch's CPU versions differ by an ulp, the "approx" class of
    tests/test_torch_ops.py) picks the sector and so the gradient.
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
from sdf_tpu.models import zoo as jzoo
from sdf_torch.core.node import Points as TPoints
from sdf_torch.core.node import cast as tcast
from sdf_torch.core.node import load_leaves, tree_leaves
from sdf_torch.models import zoo as tzoo
from sdf_torch.ops import vecmath as vm

import torch_helpers as th
from test_torch_shapes2 import CASES2, CASES3


def _zoo(name):
    return lambda m: (jzoo if m is st else tzoo).MODELS[name][0]()


CASES = {"3d/" + k: (v[0], 3) for k, v in th.op_cases().items()}
CASES.update({"2d/" + k: (v, 2) for k, v in CASES2.items()})
CASES.update({"2d3d/" + k: (v, 3) for k, v in CASES3.items()})
CASES.update({"zoo/" + k: (_zoo(k), 3) for k in sorted(jzoo.MODELS)})


def _points(dim, name, n=400):
    """Seeded points with exact zeros and ties among them."""
    p = np.random.default_rng(0).uniform(-1.2, 1.2, (n, dim))
    p[:48, 0] = 0.0
    p[48:96, 1] = 0.0
    p[96:112] = 0.0
    p[112:160, :2] = 0.0
    p[160:200, 1] = p[160:200, 0]
    p[200:240, 1] = -p[200:240, 0]
    if name == "zoo/knurling":
        x, y = p[:, 0], p[:, 1]
        p = p[(x != 0) & (y != 0) & (np.abs(x) != np.abs(y))]
    return p


@pytest.mark.parametrize("name", sorted(CASES))
def test_leaf_gradients_match_jax(name):
    build, dim = CASES[name]
    pts = _points(dim, name)
    w = np.random.default_rng(1).normal(size=len(pts))
    fj = jcast(build(st), jnp.float64)
    ft = load_leaves(build(sp), [np.asarray(x)
                                 for x in jax.tree_util.tree_leaves(fj)])

    def loss(node):
        p = JPoints(*[jnp.asarray(pts[:, i]) for i in range(dim)])
        return jnp.sum(jnp.broadcast_to(node(p), (len(pts),)) * w)

    with jax.disable_jit():
        want = [np.asarray(g) for g in
                jax.tree_util.tree_leaves(jax.grad(loss)(fj))]
    node = tcast(ft, torch.float64, "cpu")
    leaves = [x.requires_grad_(True) for x in tree_leaves(node)]
    assert len(leaves) == len(want)
    if not leaves:
        return
    d = node(TPoints(*[torch.as_tensor(pts[:, i]) for i in range(dim)]))
    d = torch.as_tensor(d).broadcast_to((len(pts),))
    got = torch.autograd.grad((d * torch.as_tensor(w)).sum(), leaves,
                              allow_unused=True)
    scale = max(float(np.abs(g).max()) if g.size else 0.0 for g in want)
    for g, wg in zip(got, want):
        g = np.zeros_like(wg) if g is None else g.numpy()
        assert g.shape == wg.shape
        np.testing.assert_allclose(g, wg, rtol=1e-9, atol=1e-12 * scale)


GRAD_CASES = sorted(k for k, (_, dim) in CASES.items() if dim == 3)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradient_and_normal_match_jax(name):
    build, _ = CASES[name]
    pts = _points(3, name)
    fj, ft = build(st), build(sp)
    g = ft.gradient(pts, dtype=torch.float64, device="cpu")
    assert g.dtype == torch.float64 and g.shape == pts.shape
    np.testing.assert_allclose(
        g.numpy(), np.asarray(fj.gradient(pts, dtype=jnp.float64)),
        rtol=0, atol=1e-12)
    n = ft.normal(pts, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(
        n.numpy(), np.asarray(fj.normal(pts, dtype=jnp.float64)),
        rtol=0, atol=1e-12)


def test_gradient_api():
    """The sphere's gradient is the unit radial direction (float32 by
    default), normals are unit, a tensor keeps its device, and device=None
    means the card."""
    rng = np.random.RandomState(5)
    p = rng.normal(size=(256, 3))
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    p *= rng.uniform(0.5, 1.5, (256, 1))
    f = sp.sphere(1.0)
    g = f.gradient(torch.as_tensor(p))
    assert g.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), p / np.linalg.norm(
        p, axis=1, keepdims=True), atol=1e-6)
    n = f.normal(p, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(np.linalg.norm(n.numpy(), axis=1), 1.0,
                               atol=1e-12)
    # A zero gradient (the sphere's centre: the safe norm's branch) stays
    # zero instead of dividing by zero.
    z = f.normal(np.zeros((4, 3)), device="cpu")
    assert torch.equal(z, torch.zeros((4, 3)))


def test_gradient_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sp.sphere(1.0).gradient(np.zeros((4, 3)))


TIES = np.array([-1.5, -1.0, -0.0, 0.0, 0.25, 0.5, 1.0, 2.0])


@pytest.mark.parametrize("op", ["abs", "max", "min", "rmax", "rmin", "clip",
                                "sqrt", "hypot", "atan2"])
def test_tie_rules_match_jax(op):
    """The helpers' values are torch's (bit for bit) and their gradients
    JAX's (NaN where JAX's is: atan2 at the origin), at ties (0, the
    bounds 0.5 and 1.0, -0.0) and away from them."""
    jfn, tfn = {
        "abs": (jnp.abs, vm._abs),
        "max": (lambda x: jnp.maximum(x, 0.5), lambda x: vm._max(x, 0.5)),
        "min": (lambda x: jnp.minimum(x, 1.0), lambda x: vm._min(x, 1.0)),
        "rmax": (lambda x: jnp.maximum(0.0, x), lambda x: vm._max(0.0, x)),
        "rmin": (lambda x: jnp.minimum(0.0, x), lambda x: vm._min(0.0, x)),
        "clip": (lambda x: jnp.clip(x, 0.0, 1.0),
                 lambda x: vm.clip(x, 0.0, 1.0)),
        "sqrt": (jnp.sqrt, vm.sqrt),
        "hypot": (lambda x: jnp.hypot(x, 0.0 * x),
                  lambda x: vm.hypot(x, 0.0 * x)),
        "atan2": (lambda x: jnp.arctan2(x, x * x),
                  lambda x: vm.arctan2(x, x * x)),
    }[op]
    xs = np.abs(TIES) + 0.25 if op == "sqrt" else TIES
    want = np.asarray(jax.vmap(jax.grad(jfn))(jnp.asarray(xs)))
    x = torch.as_tensor(xs).requires_grad_(True)
    y = tfn(x)
    (got,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=0)
    with torch.no_grad():
        plain = tfn(torch.as_tensor(xs))
    assert torch.equal(y.detach().view(torch.int64), plain.view(torch.int64))
