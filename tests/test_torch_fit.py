"""The fitting helpers, ``sdf_torch.models.fit``, against
``sdf_tpu.models.fit``.

Tolerances:
  * one ``fit_step``: loss and every leaf rtol 1e-12 in float64 against the
    jitted JAX step (sums in another order), rtol 1e-5 in float32.
  * ``fit`` and ``fit_chamfer``: the recovered radius, as the JAX
    package's own tests state it (1e-3 for ``fit``, 0.1 for the chamfer
    fit on a resolution-20 mesh, whose grid step is 0.17), and the first
    chamfer step's loss and radius rtol 1e-9 against JAX's in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
import sdf_torch as sp
from sdf_tpu.core.node import cast as jcast
from sdf_tpu.models import fit as jfit
from sdf_torch.core.node import tree_leaves
from sdf_torch.models import fit as tfit

import torch_helpers as th

BOUNDS = ((-1.6, -1.6, -1.6), (1.6, 1.6, 1.6))


def _radius(node):
    """The sphere model's radius leaf (its leaves: centre, radius)."""
    return float(tree_leaves(node)[-1].detach())


@pytest.mark.parametrize("dtype, rtol", [("float32", 1e-5),
                                         ("float64", 1e-12)])
def test_fit_step_matches_jax(dtype, rtol):
    """One SGD step of sphere(0.8) towards the example model's field: loss
    and leaves equal JAX's; the step returns leaf tensors that require a
    gradient and leaves the caller's expression as it was."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    pts = np.random.default_rng(2).uniform(-1.5, 1.5, (1024, 3)).astype(dtype)
    tgt = np.asarray(jcast(th.example(st), jd)(pts)).reshape(-1)
    node, loss = jfit.fit_step(jcast(st.sphere(0.8), jd), jnp.asarray(pts),
                               jnp.asarray(tgt), jnp.asarray(0.01, jd))
    model = sp.sphere(0.8)
    tnode, tloss = tfit.fit_step(model, torch.as_tensor(pts),
                                 torch.as_tensor(tgt), 0.01)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=rtol)
    want = jax.tree_util.tree_leaves(node)
    got = tree_leaves(tnode)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == td and g.is_leaf and g.requires_grad
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=rtol * 1e-2)
    assert float(model.params["radius"]) == 0.8


def test_fit_recovers_sphere_radius():
    """sphere(0.5) fitted to sphere(1.3)'s field (tests/test_models_fit.py's
    setup); the target as an expression and as a plain callable."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2, 2, size=(512, 3)).astype(np.float32)
    node, loss = tfit.fit(sp.sphere(0.5), sp.sphere(1.3), pts, steps=200,
                          lr=0.1, device="cpu")
    assert abs(_radius(node) - 1.3) < 1e-3
    assert loss < 1e-6
    node2, loss2 = tfit.fit(
        sp.sphere(0.5), lambda p: np.linalg.norm(p, axis=1) - 1.3, pts,
        steps=200, lr=0.1, device="cpu")
    assert abs(_radius(node2) - 1.3) < 1e-3 and loss2 < 1e-6


def _cloud(seed=11, n=384, r=1.2):
    d = np.random.RandomState(seed).normal(size=(n, 3))
    return r * d / np.linalg.norm(d, axis=1, keepdims=True)


def test_chamfer_step_matches_jax():
    """The first fit_chamfer step (resolution 20, float64): loss and radius
    equal JAX's."""
    cloud = _cloud()
    jnode, jloss = jfit.fit_chamfer(st.sphere(1.0), cloud, BOUNDS, steps=1,
                                    lr=0.05, resolution=20,
                                    dtype=jnp.float64)
    tnode, tloss = tfit.fit_chamfer(sp.sphere(1.0), cloud, BOUNDS, steps=1,
                                    lr=0.05, resolution=20,
                                    dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(tloss, jloss, rtol=1e-9)
    np.testing.assert_allclose(
        _radius(tnode), float(jax.tree_util.tree_leaves(jnode)[-1]),
        rtol=1e-9)
    # The loss function alone: the same value on the same expression.
    loss = tfit.make_chamfer_loss(BOUNDS, 20, dtype=torch.float64)
    jl = jfit.make_chamfer_loss(BOUNDS, 20, dtype=jnp.float64)
    np.testing.assert_allclose(
        float(loss(sp.sphere(1.1), torch.as_tensor(cloud))),
        float(jl(jcast(st.sphere(1.1), jnp.float64), jnp.asarray(cloud))),
        rtol=1e-9)


def test_fit_chamfer_recovers_radius():
    """Fit a sphere's radius to a cloud on radius 1.2 through the extracted
    mesh alone: the JAX package's test takes 80 steps, this one 40."""
    node, loss = tfit.fit_chamfer(sp.sphere(1.0), _cloud(), BOUNDS, steps=40,
                                  lr=0.05, resolution=20,
                                  dtype=torch.float64, device="cpu")
    assert abs(_radius(node) - 1.2) < 0.1, (_radius(node), loss)
    assert loss < 0.25


class _Ranks:
    """A stand-in for a 1-D DeviceMesh of 3 ranks, seen from rank 0."""

    def size(self):
        return 3

    def get_local_rank(self, axis=None):
        return 0

    def get_group(self, axis=None):
        return None


def test_sharded_and_mesh_forms_raise(monkeypatch):
    """The multi-device forms run (tests/test_torch_parallel.py holds them
    against JAX on ranks); what raises: a batch that does not divide over
    the mesh's ranks.  device=None means the card."""
    pts = np.zeros((8, 3))
    step = tfit.make_sharded_fit_step(_Ranks())
    with pytest.raises(ValueError, match="divide"):
        step(sp.sphere(1.0), torch.zeros((8, 3)), torch.zeros(8), 0.1)
    from sdf_torch import models

    assert models.fit_step is tfit.fit_step
    assert models.make_sharded_fit_step is tfit.make_sharded_fit_step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfit.fit(sp.sphere(1.0), sp.sphere(1.0), pts, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfit.fit_chamfer(sp.sphere(1.0), pts, BOUNDS, steps=1)
