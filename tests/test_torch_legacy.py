"""Reference-style custom SDFs in the port: bare closures under
``@sdf3``/``@op3`` (``sdf_torch.core.node._wrap_legacy``), the counterpart
of tests/test_custom_sdf.py and tests/test_pure_callback_runtime.py.

Three tiers: the closure takes the ``Points`` themselves (tier 0), an
``(N, 3)`` tensor (tier 1), or float64 numpy on the host with its result
uploaded (tier 2, the counterpart of ``jax.pure_callback``).  A legacy
closure is always a gather-marked field: recorded ahead with torch ops,
never in a generated kernel body.

Tolerances: values within 1e-12 of numpy where the tier computes in
float64; the host tier bit-equal to float64 numpy rounded to the compute
dtype, as the reference's pure_callback returns it.
"""

import numpy as np
import pytest
import torch

import sdf_torch as sp
from sdf_torch import ORIGIN, op3, sdf3
from sdf_torch.core import engine, hybrid
from sdf_torch.core.node import Points, cast
from sdf_torch.utils import checkpoint as ckpt

import torch_helpers as th


def _tier(f):
    """The memoized tier of a legacy node's closure (None before use)."""
    cells = {c.cell_contents.get("tier", "x") for c in f.fn.__closure__
             if isinstance(c.cell_contents, dict)}
    (tier,) = cells
    return tier


def test_custom_torch_closure():
    # A closure in the reference's documented style, with torch for jnp.
    @sdf3
    def my_sphere(radius=1, center=ORIGIN):
        def f(p):
            return torch.linalg.norm(p - torch.as_tensor(center), dim=1) - radius

        return f

    f = my_sphere(1.1)
    p = np.random.RandomState(0).uniform(-2, 2, (256, 3))
    expect = np.linalg.norm(p, axis=1) - 1.1
    np.testing.assert_allclose(f(p, device="cpu").numpy().reshape(-1), expect,
                               rtol=1e-12)
    assert _tier(f) == 1
    g = f & sp.box(1.5)
    pts = g.generate(samples=2**12, verbose=False, device="cpu")
    assert len(pts) > 0


def test_custom_numpy_closure_host_tier():
    # A verbatim reference closure: pure numpy, run on the host.
    @sdf3
    def np_sphere(radius=1, center=ORIGIN):
        def f(p):
            return np.linalg.norm(np.asarray(p) - center, axis=1) - radius

        return f

    f = np_sphere(0.9)
    pts = f.generate(samples=2**12, verbose=False, device="cpu")
    assert _tier(f) == 2
    r = np.linalg.norm(pts, axis=1)
    np.testing.assert_allclose(r, 0.9, atol=2e-2)


def test_host_tier_computes_in_float64():
    """The host tier runs the closure on the points as float64 numpy and
    rounds its result to the compute dtype once, as pure_callback does."""
    f = th.legacy_closure(sp)
    q = np.random.default_rng(2).uniform(-1, 1, (3, 257))
    p32 = Points(*[torch.as_tensor(c, dtype=torch.float32) for c in q])
    got = cast(f, torch.float32, "cpu")(p32)
    assert got.dtype == torch.float32 and _tier(f) == 2
    a = np.stack([c.numpy().astype(np.float64) for c in p32.c], 1)
    want = (np.linalg.norm(a, axis=1) - 0.8).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_points_native_closure():
    # Plain indexing and arithmetic: the closure takes the Points (tier 0).
    @sdf3
    def torus_like(r1=1.0, r2=0.3):
        def f(p):
            a = torch.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2) - r1
            return torch.sqrt(a * a + p[:, 2] ** 2) - r2

        return f

    f = torus_like()
    pts = f.generate(samples=2**12, verbose=False, device="cpu")
    assert len(pts) > 0 and _tier(f) == 0
    g = th.legacy_closure(sp, numpy_only=False)
    g(np.zeros((4, 3)), device="cpu")
    assert _tier(g) == 0


def test_custom_op3_closure():
    @op3
    def my_translate(other, offset):
        def f(p):
            return other(p - np.asarray(offset))

        return f

    f = sp.sphere(1).my_translate((0, 0, 2))
    p = np.array([[0.0, 0.0, 2.0], [0.0, 0.0, 0.0]])
    d = f(p, device="cpu").numpy().reshape(-1)
    np.testing.assert_allclose(d, [-1.0, 1.0], atol=1e-6)
    pts = f.generate(samples=2**12, verbose=False, device="cpu")
    assert len(pts) > 0


def test_custom_closure_respects_dtype_cast():
    # The closure captures float64 numpy values; its output is cast to the
    # points' dtype so the expression stays float32.
    @op3
    def my_translate(other, offset):
        def f(p):
            return other(p - np.asarray(offset))

        return f

    node = cast(sp.sphere(1).my_translate((0, 0, 2)), torch.float32, "cpu")
    p = Points(*[torch.zeros(4, dtype=torch.float32) for _ in range(3)])
    assert node(p).dtype == torch.float32


def test_custom_closure_bug_surfaces_clearly():
    # A typo inside the closure raises, and is not routed to the host tier.
    @sdf3
    def broken():
        def f(p):
            return np.linalg.nrom(p, axis=1)  # typo

        return f

    f = broken()
    with pytest.raises(AttributeError):
        f.generate(samples=2**9, verbose=False, device="cpu")


def test_legacy_closure_is_a_field_and_has_no_fingerprint():
    """A legacy closure is gather-marked (its field is recorded, the
    generated body reads it), has no fingerprint, and so no memo keeps its
    counts; generate() still runs and repeats itself."""
    f = th.legacy_closure(sp) & sp.box(1.2)
    assert hybrid.count_gathers(f) == 1
    X = np.linspace(-1, 1, 5)
    with pytest.raises(ValueError, match="no fingerprint"):
        ckpt.fingerprint(f, X, X, X, True)
    src = __import__("sdf_torch.core.eval_classify", fromlist=["x"]).kernel_source(
        hybrid.to_kernel_tree(f), 1)
    assert "F.p[0][fi]" in src
    engine._COUNTS_MEMO.clear()
    kw = dict(samples=2**12, verbose=False, device="cpu", sparse=False)
    a = f.generate(**kw)
    assert not engine._COUNTS_MEMO
    np.testing.assert_array_equal(a, f.generate(**kw))


def test_legacy_closure_from_the_host_tier_through_generate():
    """The numpy-only closure of tests/test_pure_callback_runtime.py, at its
    bounds, through generate() on the CPU with every cull mode: the host
    tier's field feeds the dense kernel's plain version and the tiles'."""
    def legacy(p):
        a = np.asarray(p, dtype=np.float64)
        return np.linalg.norm(a, axis=1) - 1.0

    f = sp.sdf3(lambda: legacy)()
    kw = dict(samples=2**12, verbose=False, device="cpu",
              bounds=((-1.2,) * 3, (1.2,) * 3))
    out = {s: f.generate(sparse=s, **kw) for s in (False, True, "tiles")}
    for s, pts in out.items():
        assert pts.shape[0] > 0 and pts.shape[0] % 3 == 0, s
        r = np.linalg.norm(pts, axis=1)
        assert abs(r.max() - 1.0) < 0.1, (s, r.max())
    assert th.soup_hash(out[False]) == th.soup_hash(out["tiles"])
