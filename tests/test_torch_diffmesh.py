"""The differentiable path: ``sdf_torch.core.mc``'s soup emit (``count``,
``emit``, ``interpolate_slots``), ``sdf_torch.core.sparse._emit_tiles`` and
``sdf_torch.core.diffmesh`` against the JAX package, fed the same inputs.

Tolerances:
  * integer outputs (counts, per-tile sums, case codes, ``n``, ``valid``):
    bit-equal.
  * soup vertices: within 8 eps of jitted JAX (the repo's FMA rule: jitted
    XLA on the CPU may contract the lerp's multiply-add); in practice
    bit-equal.
  * gradients with respect to a volume or a level shift: rtol 1e-12 against
    ``jax.grad``; against finite differences rtol 1e-5.
  * ``extract``'s world-space vertices: 1e-12 (jitted JAX evaluates the
    field with contracted multiply-adds, and a vertex divides field
    values).
  * leaf gradients of ``extract``/``mean_vertex`` in float64: rtol 1e-9
    (atol 1e-15 for entries that cancel to rounding noise) against
    ``jax.grad``.  For the example model the reference is ``jax.grad``
    evaluated EAGERLY: jitted XLA contracts the orient products of its three
    cylinders into FMAs, which turns exact ties between the cylinders on the
    symmetric grid into near-ties, so the jitted gradient splits them
    differently (the port and eager JAX agree to 1e-14).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
import sdf_torch as sp
from sdf_tpu.core import diffmesh as jdm
from sdf_tpu.core import engine as jengine
from sdf_tpu.core import mc as jmc
from sdf_tpu.core import sparse as jsparse
from sdf_tpu.core.node import cast as jcast
from sdf_torch.core import diffmesh as tdm
from sdf_torch.core import mc as tmc
from sdf_torch.core import sparse as tsparse
from sdf_torch.core.node import cast as tcast
from sdf_torch.core.node import load_leaves, tree_leaves

import torch_helpers as th

BOUNDS = ((-1.6, -1.6, -1.6), (1.6, 1.6, 1.6))
VARIANTS = ["default", "lewiner"]
EPS64 = np.finfo(np.float64).eps


def _volume(kind):
    """A float64 volume: the example model evaluated by the JAX package, or
    a noisy sphere field (seeded; its noise makes ambiguous cells)."""
    if kind == "example":
        X = np.arange(-1.0, 1.0, 0.09)
        Y = np.arange(-1.05, 1.0, 0.1)
        Z = np.arange(-0.95, 1.0, 0.085)
        return np.array(jengine._eval_volume(
            jcast(th.example(st), jnp.float64), X, Y, Z, jnp.float64))
    rng = np.random.default_rng(7)
    lin = np.linspace(-1.2, 1.2, 19)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    return np.sqrt(x * x + y * y + z * z) - 0.9 + 0.08 * rng.normal(
        size=x.shape)


def _inputs(kind, variant):
    """Volume, a partial cell mask (seeded) and the case codes, the lewiner
    codes from eager JAX (the jitted classify contracts multiply-adds)."""
    vol = _volume(kind)
    keep = np.random.default_rng(1).random(
        tuple(n - 1 for n in vol.shape)) < 0.8
    with jax.disable_jit():
        case = np.asarray(jmc.get_tables(variant).classify(jnp.asarray(vol)))
    return vol, keep, case


def _close_verts(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * EPS64 * scale)


@pytest.mark.parametrize("kind", ["example", "noisy"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_count_matches_jax(kind, variant):
    vol, keep, case = _inputs(kind, variant)
    want = jmc.count(jnp.asarray(vol), jnp.asarray(keep), 4,
                     case=jnp.asarray(case), variant=variant)
    got = tmc.count(torch.as_tensor(vol), torch.as_tensor(keep), 4,
                    case=torch.as_tensor(case), variant=variant)
    assert int(want[0]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Without case=: the port classifies (kernel B2's plain version).
    again = tmc.count(torch.as_tensor(vol), torch.as_tensor(keep), 4,
                      variant=variant)
    np.testing.assert_array_equal(again[3].numpy(), case)


@pytest.mark.parametrize("kind", ["example", "noisy"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_emit_matches_jax(kind, variant):
    """Soup, count and the gradient of a weighted sum of the soup with
    respect to the volume, with spare capacity and with a cell capacity
    below the active cells."""
    vol, keep, case = _inputs(kind, variant)
    n = int(jmc.count(jnp.asarray(vol), jnp.asarray(keep), 4,
                      case=jnp.asarray(case), variant=variant)[0])
    ncell = int(np.asarray(jmc.count(jnp.asarray(vol), jnp.asarray(keep), 4,
                                     case=jnp.asarray(case),
                                     variant=variant)[2]))
    for cap, ccap in ((n + 37, None), (n, ncell // 2)):
        W = np.random.default_rng(cap).normal(size=(9, cap))

        def jloss(v):
            verts, _ = jmc.emit(v, jnp.asarray(keep), cap, ccap,
                                jnp.asarray(case), variant)
            return jnp.sum(verts * W)

        want, wn = jmc.emit(jnp.asarray(vol), jnp.asarray(keep), cap, ccap,
                            jnp.asarray(case), variant)
        want_g = np.asarray(jax.grad(jloss)(jnp.asarray(vol)))
        tv = torch.as_tensor(vol).requires_grad_(True)
        got, gn = tmc.emit(tv, torch.as_tensor(keep), cap, ccap,
                           torch.as_tensor(case), variant)
        (got_g,) = torch.autograd.grad((got * torch.as_tensor(W)).sum(), tv)
        assert got.shape == (9, cap) and int(gn) == int(wn) > 0
        _close_verts(got.detach().numpy(), np.asarray(want))
        np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-12,
                                   atol=1e-12 * np.abs(want_g).max())


@pytest.mark.parametrize("variant", VARIANTS)
def test_emit_tiles_matches_jax(variant):
    """The tiles' soup on the volumes and list the tiled path builds (a
    random share of the tiles of the noisy field, padded with tile 0)."""
    vol = _volume("noisy")
    n, tile = vol.shape[0], 4
    active = th.grid_tiles(vol.shape, tile, np.random.default_rng(2), 0.6)
    nt = len(active)
    ntc = tmc.round_capacity(nt)
    tiles = np.zeros((ntc, 3), np.int32)
    tiles[:nt] = active
    live = np.arange(ntc) < nt
    ar = np.arange(tile + 1)
    vols = np.stack([
        vol[np.ix_(*[np.clip(t[a] * tile + ar, 0, n - 1) for a in range(3)])]
        for t in tiles])
    cshape = (n - 1,) * 3
    with jax.disable_jit():
        case = np.asarray(jsparse._tile_cases(jnp.asarray(vols), tile,
                                              variant))
    total, _, ncell, *_ = jsparse._count_tiles(
        jnp.asarray(vols), jnp.asarray(tiles), jnp.asarray(live), cshape,
        tile, jnp.asarray(case), variant)
    cap, ccap = int(total) + 5, int(ncell)
    want, wn = jsparse._emit_tiles(
        jnp.asarray(vols), jnp.asarray(tiles), jnp.asarray(live),
        jnp.asarray(case), cshape, cap, ccap, tile, variant)
    got, gn = tsparse._emit_tiles(
        torch.as_tensor(vols), torch.as_tensor(tiles), torch.as_tensor(live),
        torch.as_tensor(case), cshape, cap, ccap, tile, variant)
    assert int(gn) == int(wn) == int(total) > 0
    _close_verts(got.numpy(), np.asarray(want))


def test_overflow_is_observable():
    """A capacity below the surface: ``n`` is the true total, a warning
    fires, and exactly ``capacity`` triangles are valid."""
    node = sp.sphere(1.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        verts, n, valid = tdm.extract(node, BOUNDS, 32, capacity=64,
                                      dtype=torch.float64, device="cpu")
    want_n = int(jdm.extract(jcast(st.sphere(1.0), jnp.float64), BOUNDS, 32,
                             dtype=jnp.float64)[1])
    assert int(n) == want_n > 64
    assert int(valid.sum()) == 64 and valid[:64].all()
    assert verts.shape == (64, 3, 3)
    assert any("capacity=64" in str(w.message) for w in caught)
    # At the default capacity (4 * 32^2) nothing is dropped and no warning.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, n2, valid2 = tdm.extract(node, BOUNDS, 32, dtype=torch.float64,
                                    device="cpu")
    assert int(n2) == int(valid2.sum()) == want_n
    assert not [w for w in caught if "capacity" in str(w.message)]


def _tunnel_volume():
    """A (2, 2, 2) volume of a case-65 tunnel realization, taken from the
    JAX package's table generator (the port has no sampler)."""
    from sdf_tpu.core import mc33_build as mb

    rng = np.random.default_rng(5)
    for _ in range(200):
        cand = mb.sample_realizations(65, 500, rng)
        hit = np.flatnonzero(mb.interior_bits(cand) == 1)
        if len(hit):
            v = cand[hit[0]]
            break
    else:
        raise AssertionError("no case-65 tunnel realization found")
    vol = np.zeros((2, 2, 2))
    for ci, (ox, oy, oz) in enumerate(np.asarray(mb.CORNER_OFFSETS)):
        vol[ox, oy, oz] = v[ci]
    return vol


def test_tunnel_cell_gradient():
    """The lewiner tunnel: 6 triangles (the fast tables give 2), and the
    gradient of the soup with respect to a level shift matches jax.grad and
    finite differences."""
    vol0 = _tunnel_volume()
    mask = torch.ones((1, 1, 1), dtype=torch.bool)
    _, n = tmc.emit(torch.as_tensor(vol0), mask, 8, variant="lewiner")
    assert int(n) == 6
    assert int(tmc.emit(torch.as_tensor(vol0), mask, 8)[1]) == 2
    w = (np.arange(8) < 6).astype(np.float64)

    def loss(theta):
        verts, _ = tmc.emit(torch.as_tensor(vol0) - theta, mask, 8,
                            variant="lewiner")
        return (verts * torch.as_tensor(w)[None, :]).sum()

    theta = torch.zeros((), dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(theta), theta)

    def jloss(theta):
        verts, _ = jmc.emit(jnp.asarray(vol0) - theta,
                            jnp.ones((1, 1, 1), bool), 8, variant="lewiner")
        return jnp.sum(verts * w[None, :])

    want = float(jax.grad(jloss)(jnp.float64(0.0)))
    eps = 1e-6
    with torch.no_grad():
        up, down = (float(loss(torch.tensor(e, dtype=torch.float64)))
                    for e in (eps, -eps))
    fd = (up - down) / (2 * eps)
    assert abs(float(g)) > 1e-9
    np.testing.assert_allclose(float(g), want, rtol=1e-12)
    np.testing.assert_allclose(float(g), fd, rtol=1e-5)


CASES = {
    "sphere": (lambda m: m.sphere(1.0), 24, False),
    "sphere_or_box_k": (lambda m: m.sphere(1.0).union(m.box(1.5), k=0.2), 24,
                        False),
    "example": (th.example, 20, True),
}


@pytest.mark.parametrize("variant", ["lewiner", "fast"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_extract_and_mean_vertex_match_jax(name, variant):
    """n, valid and the vertices of extract, and the gradient of a weighted
    sum of mean_vertex with respect to every leaf, float64."""
    build, res, eager = CASES[name]
    fj = jcast(build(st), jnp.float64)
    ft = load_leaves(build(sp), [np.asarray(x)
                                 for x in jax.tree_util.tree_leaves(fj)])
    w = np.array([1.0, 2.0, 3.0])

    def jprobe(node):
        return jnp.sum(jdm.mean_vertex(node, BOUNDS, res, dtype=jnp.float64,
                                       variant=variant) * w)

    vj, nj, okj = jdm.extract(fj, BOUNDS, res, dtype=jnp.float64,
                              variant=variant)
    if eager:
        with jax.disable_jit():
            gj = jax.grad(jprobe)(fj)
    else:
        gj = jax.grad(jprobe)(fj)
    gj = [np.asarray(x) for x in jax.tree_util.tree_leaves(gj)]

    vt, nt, okt = tdm.extract(ft, BOUNDS, res, dtype=torch.float64,
                              variant=variant, device="cpu")
    assert int(nt) == int(nj) > 0
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    # The vertices divide field values, which jitted JAX computes with
    # contracted multiply-adds: 1e-12 here, not the emit's 8 eps.
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-12)

    node = tcast(ft, torch.float64, "cpu")
    leaves = [x.requires_grad_(True) for x in tree_leaves(node)]
    mv = tdm.mean_vertex(node, BOUNDS, res, dtype=torch.float64,
                         variant=variant, device="cpu")
    np.testing.assert_allclose(
        mv.detach().numpy(),
        np.asarray(jdm.mean_vertex(fj, BOUNDS, res, dtype=jnp.float64,
                                   variant=variant)), rtol=1e-12, atol=1e-15)
    gt = torch.autograd.grad((mv * torch.as_tensor(w)).sum(), leaves)
    assert len(gt) == len(gj)
    for a, b in zip(gt, gj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-15)
    assert any(np.abs(b).max() > 1e-3 for b in gj)


def test_extract_variants_and_errors(monkeypatch):
    """"fast" and the legacy "default" name give the same mesh; an unknown
    variant raises; extract_sharded without a mesh needs torch.distributed
    (its runs on ranks: tests/test_torch_parallel.py); device=None means
    the card and raises without one."""
    a = tdm.extract(sp.sphere(1.0), BOUNDS, 20, device="cpu", variant="fast")
    b = tdm.extract(sp.sphere(1.0), BOUNDS, 20, device="cpu",
                    variant="default")
    assert a[0].dtype == torch.float32 and a[0].shape == (1600, 3, 3)
    assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
    with pytest.raises(ValueError, match="mc_variant"):
        tdm.extract(sp.sphere(1.0), BOUNDS, 20, device="cpu", variant="mc33")
    with pytest.raises(RuntimeError, match="initialize"):
        tdm.extract_sharded(sp.sphere(1.0), BOUNDS, 20, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdm.extract(sp.sphere(1.0), BOUNDS, 20)
