"""Mesh import and mesh SDFs (``sdf_torch.ops.meshsdf``) against
``sdf_tpu.ops.meshsdf``, on a seed-free closed mesh (a twice subdivided
icosphere, tests/torch_helpers.py) and seed-made query points.

Tolerances:
  * ``_mesh_distance_field`` (float32 in both packages): signs equal
    wherever the winding number (computed here in float64 numpy) is farther
    than 0.1 from 0.5; |distance| within 1e-6 (8 float32 ulps at 1).  The
    reference is jitted XLA, which contracts multiply-adds into FMAs and
    sums the solid angles in its own order; the port does neither, so the
    values differ by an ulp or so.
  * ``Mesh.sdf`` grids: the same tolerance (they are that function,
    clamped); the port's field on the JAX package's own grid (carried
    across with ``load_leaves``) is bit-equal to the reference in float64.
  * mesh I/O and transforms: equal.
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
from sdf_tpu.ops import meshsdf as jmesh
from sdf_torch.core import hybrid
from sdf_torch.core.node import Points as TPoints
from sdf_torch.core.node import cast as tcast
from sdf_torch.core.node import load_leaves
from sdf_torch.ops import meshsdf as tmesh

import torch_helpers as th

DIST_TOL = 1e-6


def _winding(pts, tris):
    """The generalized winding number of the soup at ``pts``, float64."""
    a, b, c = (tris[None, :, i, :] - pts[:, None, :] for i in range(3))
    la, lb, lc = (np.linalg.norm(v, axis=-1) for v in (a, b, c))
    det = np.sum(a * np.cross(b, c), -1)
    dd = (la * lb * lc + np.sum(a * b, -1) * lc + np.sum(b * c, -1) * la
          + np.sum(c * a, -1) * lb)
    return np.sum(2 * np.arctan2(det, dd), 1) / (4 * np.pi)


def _soup():
    pts, tris = th.sphere_mesh_points()
    return pts, tris, pts[tris]


@pytest.mark.parametrize("tchunks", [1, 4])
def test_mesh_distance_field_matches_jax(tchunks):
    _, _, soup = _soup()
    q = np.random.default_rng(3).uniform(-1.3, 1.3, (2048, 3))
    q[:64] *= 0.999 / np.linalg.norm(q[:64], axis=1, keepdims=True)
    want = np.asarray(jmesh._mesh_distance_field(
        *(jnp.asarray(a, jnp.float32) for a in
          (q, soup[:, 0], soup[:, 1], soup[:, 2])), 4, tchunks))
    got = tmesh._mesh_distance_field(
        *(torch.as_tensor(a, dtype=torch.float32) for a in
          (q, soup[:, 0], soup[:, 1], soup[:, 2])), 4, tchunks).numpy()
    assert got.dtype == np.float32 and got.shape == (2048,)
    clear = np.abs(_winding(q, soup) - 0.5) > 0.1
    assert clear.sum() > 1900
    np.testing.assert_array_equal(np.sign(got[clear]), np.sign(want[clear]))
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=0,
                               atol=DIST_TOL)


def test_mesh_transforms_match():
    pts, tris, _ = _soup()
    mt, mj = sp.Mesh(pts, tris), st.Mesh(pts, tris)
    pairs = [
        (mt.scaled((1, 2, 3)), mj.scaled((1, 2, 3))),
        (mt.scaled(0.5), mj.scaled(0.5)),
        (mt.translated((0.1, -0.2, 0.3)), mj.translated((0.1, -0.2, 0.3))),
        (mt.positioned((1, 1, 1), (0, 0.5, 1)),
         mj.positioned((1, 1, 1), (0, 0.5, 1))),
        (mt.scaled(2).centered(), mj.scaled(2).centered()),
    ]
    for a, b in pairs:
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.triangles, b.triangles)
        assert a.size == b.size and a.bounding_box == b.bounding_box


@pytest.mark.parametrize("ext", ["stl", "obj", "ply"])
def test_from_file_matches(tmp_path, ext):
    from sdf_torch.io import meshfmt

    pts, tris, _ = _soup()
    path = str(tmp_path / ("ico." + ext))
    meshfmt.write_indexed(path, pts, tris)
    mt, mj = sp.Mesh.from_file(path), st.Mesh.from_file(path)
    np.testing.assert_array_equal(mt.points, mj.points)
    np.testing.assert_array_equal(mt.triangles, mj.triangles)
    assert len(mt.triangles) == len(tris)


def _mesh_sdfs():
    pts, tris, _ = _soup()
    kw = dict(voxel_size=0.1, half_width=0.25, chunk_points=2**12)
    return (sp.Mesh(pts, tris).sdf(device="cpu", **kw),
            st.Mesh(pts, tris).sdf(**kw))


def test_mesh_sdf_grid_and_attributes():
    ft, fj = _mesh_sdfs()
    assert hybrid.count_gathers(ft) == 1
    assert ft.array.dtype == np.float32 and ft.array.shape == fj.array.shape
    np.testing.assert_allclose(ft.array, fj.array, rtol=0, atol=DIST_TOL)
    assert ft.background == fj.background == 0.30000000000000004
    for a, b in zip(ft.xyz, fj.xyz):
        np.testing.assert_array_equal(a, b)
    assert ft.estimator is not None
    with pytest.raises(AttributeError):
        ft.no_such_attribute


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mesh_sdf_field_on_the_reference_grid(dtype):
    """The JAX package's grid carried into the port's tree with
    load_leaves: the gated trilinear field equals the reference's (float64
    bit-equal; float32 within 8 eps32), inside, near and outside the grid."""
    ft, fj = _mesh_sdfs()
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(fj)]
    ft = load_leaves(ft, leaves)
    q = np.random.default_rng(4).uniform(-1.8, 1.8, (4096, 3))
    fc = jcast(fj, getattr(jnp, dtype))
    with jax.disable_jit():
        want = np.asarray(jnp.broadcast_to(fc(JPoints(
            *[jnp.asarray(q[:, i], getattr(jnp, dtype)) for i in range(3)])),
            (len(q),)))
    tc = tcast(ft, getattr(torch, dtype), "cpu")
    got = torch.as_tensor(tc(TPoints(
        *[torch.as_tensor(q[:, i], dtype=getattr(torch, dtype))
          for i in range(3)]))).broadcast_to((len(q),)).numpy()
    if dtype == "float64":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=8 * np.finfo(np.float32).eps)
