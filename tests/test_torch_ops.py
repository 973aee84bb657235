"""Every ported primitive and op, sdf_torch against sdf_tpu, in float64.

The same seeded points go through both packages.  The JAX expression is
evaluated EAGERLY (op by op): jitted XLA on the CPU contracts
multiply-adds into FMAs, which the port deliberately does not do (its CUDA
kernel is built with -fmad=false to equal its plain PyTorch version).

Tolerances:
  * ``exact`` ops use only + - * / sqrt min max abs where: bit-equal.
  * ``approx`` ops call cos/sin/atan2/exp2/pow, whose CPU implementations
    differ between XLA and PyTorch by an ulp or two, or ``jnp.hypot``,
    which is jitted inside JAX (so contracted to FMA): |diff| <= 1e-12.
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
from sdf_torch.core.node import Points as TPoints
from sdf_torch.core.node import cast as tcast
from sdf_torch.core.node import load_leaves, tree_leaves

import torch_helpers as th


CASES = th.op_cases()
TOL = {"exact": 0.0, "approx": 1e-12}


def _points(seed=0, n=4096):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, (n, 3))


def _jax_eval(f, pts, dtype=jnp.float64):
    fc = jcast(f, dtype)
    d = fc(JPoints(*[jnp.asarray(pts[:, i], dtype) for i in range(3)]))
    return np.asarray(jnp.broadcast_to(d, (len(pts),)))


def _torch_eval(f, pts, dtype=torch.float64):
    fc = tcast(f, dtype, "cpu")
    d = fc(TPoints(*[torch.as_tensor(pts[:, i], dtype=dtype) for i in range(3)]))
    return torch.as_tensor(d).broadcast_to((len(pts),)).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax_f64(name):
    build, tol = CASES[name]
    pts = _points()
    a = _jax_eval(build(st), pts)
    b = _torch_eval(build(sp), pts)
    assert a.shape == b.shape
    if TOL[tol] == 0.0:
        np.testing.assert_array_equal(b, a)
    else:
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL[tol])


@pytest.mark.parametrize("name", sorted(CASES))
def test_generated_body_matches_plain(name):
    """The CUDA kernel's generated per-point body, interpreted with numpy,
    equals the port's plain torch evaluation (bit-equal except where numpy's
    and PyTorch's libm differ)."""
    build, tol = CASES[name]
    f = build(sp)
    pts = _points(seed=1, n=2048)
    src = ec.kernel_source(f)
    P = ec._flat_params(f, torch.float64, "cpu").numpy()
    got = th.run_body(src, pts[:, 0], pts[:, 1], pts[:, 2], P)
    want = _torch_eval(f, pts)
    got = np.broadcast_to(got, want.shape)
    if TOL[tol] == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[tol])


def test_slice_is_2d():
    """slice() returns a 2D field on (N, 2) points (public contract)."""
    pts = _points(seed=2, n=512)[:, :2]
    a = np.asarray(st.sphere(0.7).slice()(jnp.asarray(pts)))
    b = sp.sphere(0.7).slice()(torch.as_tensor(pts)).numpy()
    np.testing.assert_array_equal(b, a)


def test_public_call_contract():
    """(N, 3) -> (N, 1), including the N == dim padding case."""
    for n in (3, 5):
        pts = _points(seed=3, n=n)
        a = np.asarray(th.example(st)(jnp.asarray(pts)))
        b = th.example(sp)(torch.as_tensor(pts)).numpy()
        assert b.shape == (n, 1)
        np.testing.assert_array_equal(b, a)


def test_load_leaves_round_trip():
    """Perturb the JAX expression's leaves with numpy noise, carry them
    across with load_leaves, and the volumes still match (float64, exact)."""
    fj = th.example(st)
    leaves, treedef = jax.tree_util.tree_flatten(jcast(fj, jnp.float64))
    rng = np.random.default_rng(4)
    noisy = [np.asarray(l) + rng.normal(0, 0.01, np.shape(l)) for l in leaves]
    fj2 = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(l) for l in noisy])
    ft = load_leaves(th.example(sp), noisy)
    got = [np.asarray(l) for l in tree_leaves(ft)]
    assert len(got) == len(noisy)
    for g, w in zip(got, noisy):
        np.testing.assert_array_equal(g, w)
    pts = _points(seed=5)
    np.testing.assert_array_equal(_torch_eval(ft, pts), _jax_eval(fj2, pts))


def test_load_leaves_rejects_mismatch():
    ft = th.example(sp)
    leaves = [np.asarray(l) for l in tree_leaves(ft)]
    with pytest.raises(ValueError):
        load_leaves(ft, leaves[:-1])
    bad = list(leaves)
    bad[0] = np.zeros(7)
    with pytest.raises(ValueError):
        load_leaves(ft, bad)
