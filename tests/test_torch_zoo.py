"""The model zoo, sdf_torch against sdf_tpu: each model's volume on a 24^3
grid in float64, the JAX expression evaluated eagerly (see
tests/test_torch_ops.py), and the saddle model as the certificate that the
two marching-cubes variants differ.

Tolerances:
  * ``exact`` models use only + - * / sqrt min max abs where: bit-equal.
  * ``approx`` models call sin/cos/atan2 (circular_array, twist, the
    gyroid), whose CPU implementations may differ between XLA and PyTorch
    by an ulp or two of values of magnitude <= 12: |diff| <= 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_tpu.core import mc33 as jm
from sdf_tpu.core.node import Points as JPoints
from sdf_tpu.core.node import cast as jcast
from sdf_tpu.models import zoo as jzoo
from sdf_tpu.parallel import grid as pgrid
import sdf_torch as sp
from sdf_torch.core import mc33 as tm
from sdf_torch.core.node import Points as TPoints
from sdf_torch.core.node import cast as tcast
from sdf_torch.core.node import tree_leaves
from sdf_torch.models import zoo as tzoo

import torch_helpers as th

# name -> (half extent of the sampled box, tolerance class)
ZOO = {
    "example": (1.1, "exact"),
    "blobby": (4.2, "exact"),
    "gearlike": (2.3, "approx"),
    "knurling": (2.8, "approx"),
    "pawn": (2.6, "exact"),
    "weave": (12.5, "approx"),
    "customizable_box_body": (7.0, "exact"),
    "customizable_box_lid": (7.0, "exact"),
    "saddle": (1.5, "approx"),
}
TOL = {"exact": 0.0, "approx": 1e-12}
N = 24


def _pair(name):
    if name == "saddle":
        return th.saddle_pair(37.0, 0.15, 1.3)
    return getattr(jzoo, name)(), getattr(tzoo, name)()


def _axes(b):
    return (np.linspace(-b, b, N), np.linspace(-0.9 * b, b, N),
            np.linspace(-b, 0.95 * b, N))


def _jax_volume(f, axes):
    X, Y, Z = (jnp.asarray(a, jnp.float64) for a in axes)
    d = jcast(f, jnp.float64)(
        JPoints(X[:, None, None], Y[None, :, None], Z[None, None, :]))
    return np.asarray(jnp.broadcast_to(d, (N, N, N)))


def _torch_volume(f, axes):
    X, Y, Z = (torch.as_tensor(a, dtype=torch.float64) for a in axes)
    d = tcast(f, torch.float64, "cpu")(
        TPoints(X[:, None, None], Y[None, :, None], Z[None, None, :]))
    return torch.as_tensor(d).broadcast_to((N, N, N)).numpy()


def test_models_lists_what_is_ported():
    assert set(tzoo.MODELS) == set(jzoo.MODELS)
    for name, (build, samples) in tzoo.MODELS.items():
        assert samples == jzoo.MODELS[name][1]
        assert isinstance(build(), sp.SDF3)
    assert sp.models.saddle is tzoo.saddle


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_volume_matches_jax(name):
    half, tol = ZOO[name]
    fj, ft = _pair(name)
    axes = _axes(half)
    want, got = _jax_volume(fj, axes), _torch_volume(ft, axes)
    assert (want < 0).any() and (want > 0).any()
    if TOL[tol] == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[tol])


def test_saddle_parameters_are_leaves():
    """omega, t and r reach the port's model as parameter leaves."""
    _, ft = th.saddle_pair(31.0, 0.3, 1.2)
    vals = [np.asarray(x).tolist() for x in tree_leaves(ft)]
    assert vals == [31.0, 0.3, [0.0, 0.0, 0.0], 1.2]


def test_saddle_variants_differ():
    """On the saddle model, and on no other of the zoo, the lewiner and
    fast tables mesh differently: a lewiner path that used the fast tables
    would show here."""
    _, ft = th.saddle_pair()
    kw = dict(samples=2**15, verbose=False, dtype=torch.float64, device="cpu")
    lew = ft.generate(**kw)
    fast = ft.generate(mc_variant="fast", **kw)
    assert len(lew) != len(fast)
    assert th.soup_hash(lew) != th.soup_hash(fast)
    ex = tzoo.example()
    assert th.soup_hash(ex.generate(**kw)) == th.soup_hash(
        ex.generate(mc_variant="fast", **kw))


def test_saddle_generate_matches_jax():
    """Both variants' triangle counts on the saddle model equal the JAX
    package's (float64, a small grid), and the lewiner soup agrees within
    1e-9 after canonical ordering (sin/cos differ by ulps between XLA and
    PyTorch on the CPU)."""
    fj, ft = th.saddle_pair()
    for variant in ("lewiner", "fast"):
        want = fj.generate(samples=2**15, verbose=False, dtype=jnp.float64,
                           mc_variant=variant,
                           mesh=pgrid.make_mesh(jax.devices()[:1]))
        got = ft.generate(samples=2**15, verbose=False, dtype=torch.float64,
                          mc_variant=variant, device="cpu")
        assert len(got) == len(want)
        if variant == "lewiner":
            a = np.sort(got.reshape(-1, 9), axis=0)
            b = np.sort(want.reshape(-1, 9), axis=0)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def test_saddle_ext_grid_on_the_jax_volume():
    """The port's ext grid on the JAX package's saddle volume is bit-equal
    to the JAX package's (eager), and holds codes the fast tables cannot
    express."""
    fj, _ = th.saddle_pair()
    b = 1.5
    vol = _jax_volume(fj, (np.linspace(-b, b, N),) * 3)
    with jax.disable_jit():
        want = np.asarray(jm._classify_ext_jit(jnp.asarray(vol), 0.0, None))
    got = tm.classify_ext(torch.as_tensor(vol)).numpy()
    np.testing.assert_array_equal(got, want)
    extra = tm.extra_bits(tm._corners(torch.as_tensor(vol))).numpy()
    assert (extra & 63).any() and (extra >> 6).any()
