"""The sharded port (``sdf_torch.parallel``, ``generate(mesh=)``,
``diffmesh.extract_sharded``, ``models.fit``'s sharded forms) on gloo
ranks on the CPU, against the JAX package on the matching mesh of
conftest's virtual devices.

One spawn of 5 ranks (``torch_helpers.parallel_rank``) runs every case of
the port, on meshes of 4 ranks (0-3), 5 ranks and one rank; the tests
compare what rank 0 wrote with the JAX package, run here.

Tolerances:
  * counts and per-tile statistics: equal.
  * port 1 rank against 4 or 5 ranks: canonical soups bit-equal.
  * port against JAX: canonical soups within 1e-12 in float64 (jitted XLA
    contracts multiply-adds into FMAs, the repo's rule).
  * ``extract_sharded`` against JAX's: n and valid equal; x and y
    coordinates within 1e-12, z within 1e-12 plus 4 ulps of the grid's z
    extent: the port adds a slab's offset to the integer z before the
    interpolation, JAX after it.  Against the port's own ``extract``: the
    valid rows bit-equal.  Leaf gradients of the mean vertex rtol 1e-9
    against ``jax.grad`` of the single-device ``extract`` (the same
    triangles; the model has no exact ties, so jitted and eager JAX agree,
    and JAX's sharded gradient costs half a minute to compile here).
  * the sharded fit step: loss and leaves rtol 1e-6 (float32) and 1e-12
    (float64) against JAX's; ``fit(mesh=)`` and one ``fit_chamfer(mesh=)``
    step rtol 1e-9 against JAX's single-device runs of the same (trimmed)
    batch, which the sharded ones equal up to the order of a sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
import sdf_torch as sp
from sdf_tpu.core import diffmesh as jdm
from sdf_tpu.core.node import cast as jcast
from sdf_tpu.models import fit as jfit
from sdf_tpu.parallel import grid as jgrid
from sdf_tpu.parallel import sparse as jsparse

import torch_helpers as th

VARIANTS = ["lewiner", "default"]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Rank 0's results of the one 5-rank spawn."""
    return th.spawn_ranks(th.parallel_rank, 5,
                          tmp_path_factory.mktemp("ranks"))


def _jmesh(k):
    return jgrid.make_mesh(jax.devices()[:k])


def _close(got, want, atol=1e-12):
    """Canonical soups of one triangle count within ``atol`` (sorted on
    coordinates rounded to 6 places, so that noise does not reorder)."""
    got = np.asarray(got, np.float64).reshape(-1, 9)
    want = np.asarray(want, np.float64).reshape(-1, 9)
    assert got.shape == want.shape
    key = lambda a: a[np.lexsort(np.round(a, 6).T[::-1])]
    np.testing.assert_allclose(key(got), key(want), rtol=0, atol=atol)


@pytest.mark.parametrize("variant", VARIANTS)
def test_grid_slabs_match_jax(port, variant):
    """mesh_and_march on 4 ranks: counts and global per-tile statistics
    equal JAX's on 4 devices, the soup within 1e-12; 1, 4 and 5 ranks give
    bit-equal canonical soups and equal statistics."""
    X, Y, Z, skip = th.shard_grid()
    want, wpt = jgrid.mesh_and_march(
        jcast(th.example(st), jnp.float64), X, Y, Z, skip, th.SHARD_TILE,
        _jmesh(4), jnp.float64, variant=variant)
    full, pt, local = port[("grid4", variant)]
    assert local < len(full) == len(want) > 0
    np.testing.assert_array_equal(pt, np.asarray(wpt))
    _close(full, want)
    one, pt1 = port[("grid1", variant)]
    full5, pt5, _ = port[("grid5", variant)]
    assert np.array_equal(th.canon(full), th.canon(one))
    assert np.array_equal(th.canon(full5), th.canon(one))
    np.testing.assert_array_equal(pt1, pt)
    np.testing.assert_array_equal(pt5, pt)


@pytest.mark.parametrize("variant", VARIANTS)
def test_tile_list_matches_jax(port, variant):
    """mesh_sparse_tiles_sharded on 4 ranks against JAX's on 4 devices;
    1, 4 and 5 ranks bit-equal; the tiles' soup is the slabs' soup."""
    X, Y, Z, skip = th.shard_grid()
    want, wpt = jsparse.mesh_sparse_tiles_sharded(
        jcast(th.example(st), jnp.float64), X, Y, Z, skip, th.SHARD_TILE,
        _jmesh(4), jnp.float64, variant=variant)
    full, pt, _ = port[("tiles4", variant)]
    assert len(full) == len(want) > 0
    np.testing.assert_array_equal(pt, np.asarray(wpt))
    _close(full, want)
    one, pt1 = port[("tiles1", variant)]
    full5, pt5, _ = port[("tiles5", variant)]
    for other in (one, full5, port[("grid1", variant)][0]):
        assert np.array_equal(th.canon(full), th.canon(other))
    np.testing.assert_array_equal(pt1, pt)
    np.testing.assert_array_equal(pt5, pt)


def test_fewer_tiles_than_ranks(port):
    """Three live tiles over 4 and 5 ranks: a rank with no live row still
    joins every collective; the result equals JAX's on 4 devices."""
    X, Y, Z, skip = th.shard_grid()
    few = th.few_tiles_skip(skip.shape)
    want, wpt = jsparse.mesh_sparse_tiles_sharded(
        jcast(th.example(st), jnp.float64), X, Y, Z, few, th.SHARD_TILE,
        _jmesh(4), jnp.float64, variant="lewiner")
    full4, pt4, local0 = port["few4"]
    full5, pt5, _ = port["few5"]
    assert len(full4) == len(want) > local0 > 0
    np.testing.assert_array_equal(pt4, np.asarray(wpt))
    np.testing.assert_array_equal(pt5, pt4)
    _close(full4, want)
    assert np.array_equal(th.canon(full4), th.canon(full5))


def test_nondividing_slabs_and_statistics(port):
    """sphere, step 0.09: 24 z cells over 5 ranks (5 a slab, the last with
    one padded cell); equal to JAX's generate on 5 devices, statistics
    too."""
    kw = dict(step=0.09, bounds=((-1.1,) * 3, (1.1,) * 3), verbose=False,
              dtype=jnp.float64)
    want = st.generate(st.sphere(1), mesh=_jmesh(5), **kw)
    from sdf_tpu.core import engine as jengine

    jstats = dict(jengine.LAST_STATS)
    full, stats = port["nondiv"]
    assert len(full) == len(want) > 0
    _close(full, want)
    for key in ("batches", "skipped", "empty", "nonempty"):
        assert stats[key] == jstats[key], key
    assert "mesh_and_march" in stats and "mc33_conflicted_cells" not in stats


def test_engine_mesh_routes(port):
    """generate(mesh=) of 4 ranks: points and output="mesh" give the same
    soup, sparse="tiles" the tiled route with the same soup, each equal to
    the single-device port; the auto-mesh of the 5-rank world equals an
    explicit mesh of 5; a mesh of one rank is the single-device run."""
    kw = dict(samples=2**14, verbose=False, dtype=torch.float64, device="cpu")
    single = sp.generate(th.example(sp), **kw)
    pts, stats, from_mesh, tiles, tstats = port["engine4"]
    assert "mesh_and_march" in stats and "sparse_tiles_sharded" in tstats
    assert stats["triangles"] < len(pts) // 3
    for got in (pts, from_mesh, tiles):
        assert np.array_equal(th.canon(got), th.canon(single))
    auto, auto_sharded = port["auto"]
    assert auto_sharded and np.array_equal(th.canon(auto), th.canon(single))
    assert np.array_equal(port["one"], single)
    one = port["gather1"]
    for got, want in zip(port["gather4"], one):
        assert len(want) > 0
        assert np.array_equal(th.canon(got), th.canon(want))


@pytest.mark.parametrize("variant", VARIANTS)
def test_certificate_one_rank_equals_four(port, variant):
    """__graft_entry__'s certificate (MULTICHIP_r05.json): the example on
    np.arange(-1.2, 1.2, 0.15), float32, slabs at tile 32 and the tile
    list at tile 16: 1,024 triangles, 4 ranks bit-equal to 1."""
    for name in ("cert", "cert_tiles"):
        full, one = port[(name, variant)]
        assert len(full) == len(one) == 3 * 1024
        assert np.array_equal(th.canon(full), th.canon(one))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_extract_sharded_matches_jax(port, dtype):
    """extract_sharded of two spheres on 4 ranks: n, valid and the world
    vertices against JAX's on 4 devices; the valid rows bit-equal to the
    port's extract; leaf gradients against jax.grad (float64)."""
    verts, n, valid, grads = port[("extract", "torch." + dtype)]
    v1, n1, valid1, g1 = port[("extract1", "torch." + dtype)]
    assert n == n1 > 0 and valid.sum() == valid1.sum() == n
    assert verts.shape == (4 * th.TWO_SPHERES_CAP, 3, 3)
    assert np.array_equal(th.canon(verts[valid]), th.canon(v1[valid1]))
    for a, b in zip(grads, g1):
        np.testing.assert_allclose(a, b, rtol=1e-9 if dtype == "float64"
                                   else 1e-4, atol=1e-12)
    if dtype == "float32":
        return
    fj = jcast(th.two_spheres(st), jnp.float64)
    jv, jn, jvalid = jdm.extract_sharded(
        fj, th.SHARD_BOUNDS, th.TWO_SPHERES_RES, th.TWO_SPHERES_CAP,
        jnp.float64, mesh=_jmesh(4))
    assert int(jn) == n
    np.testing.assert_array_equal(valid, np.asarray(jvalid))
    jv = np.asarray(jv)
    np.testing.assert_allclose(verts[..., :2][valid], jv[..., :2][valid],
                               rtol=0, atol=1e-12)
    extent = th.SHARD_BOUNDS[1][2] - th.SHARD_BOUNDS[0][2]
    np.testing.assert_allclose(verts[..., 2][valid], jv[..., 2][valid],
                               rtol=0, atol=1e-12 + 4 * np.finfo(
                                   np.float64).eps * extent)
    w = np.array([1.0, 2.0, 3.0])

    def probe(node):
        return jnp.sum(jdm.mean_vertex(
            node, th.SHARD_BOUNDS, th.TWO_SPHERES_RES, th.TWO_SPHERES_CAP,
            jnp.float64) * w)

    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.grad(probe)(fj))]
    assert len(grads) == len(want)
    for a, b in zip(grads, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-15)
    assert any(np.abs(b).max() > 1e-3 for b in want)


@pytest.mark.parametrize("dtype, rtol", [("float32", 1e-6),
                                         ("float64", 1e-12)])
def test_sharded_fit_step_matches_jax(port, dtype, rtol):
    """One sharded SGD step of sphere(0.8) towards the example model's field
    over 4 ranks, against JAX's make_sharded_fit_step on 4 devices; every
    rank ends with the same leaves; a batch that does not divide raises."""
    jd = getattr(jnp, dtype)
    pts = th.fit_inputs(dtype)
    tgt = np.asarray(jcast(th.example(st), jd)(pts)).reshape(-1)
    node, loss = jfit.make_sharded_fit_step(_jmesh(4))(
        jcast(st.sphere(0.8), jd), jnp.asarray(pts), jnp.asarray(tgt),
        jnp.asarray(0.01, jd))
    tloss, leaves = port[("fit", dtype)]
    np.testing.assert_allclose(tloss, float(loss), rtol=rtol)
    want = jax.tree_util.tree_leaves(node)
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol,
                                   atol=rtol * 1e-2)
    assert port["fit_odd_batch_raises"]


def test_fit_and_chamfer_with_mesh_match_jax(port):
    """fit(mesh=) trims 1,023 points to 1,020 and equals JAX's fit(mesh=)
    of 4 devices; one fit_chamfer(mesh=) step equals JAX's fit_chamfer
    step (float64)."""
    pts = np.random.default_rng(1).uniform(-2, 2, (1023, 3))
    jnode, jloss = jfit.fit(
        st.sphere(0.5), lambda p: np.linalg.norm(p, axis=1) - 1.3, pts,
        steps=3, lr=0.1, dtype=jnp.float64, mesh=_jmesh(4))
    loss, leaves = port["fit_mesh"]
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    for g, w in zip(leaves, jax.tree_util.tree_leaves(jnode)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-9, atol=1e-15)
    jnode, jloss = jfit.fit_chamfer(
        st.sphere(1.0), th.chamfer_cloud(), th.SHARD_BOUNDS, steps=1,
        lr=0.05, resolution=20, dtype=jnp.float64)
    loss, leaves = port["chamfer"]
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    np.testing.assert_allclose(leaves[-1],
                               float(jax.tree_util.tree_leaves(jnode)[-1]),
                               rtol=1e-9)
