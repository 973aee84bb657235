"""Gather-bearing models through ``generate()`` on the CPU, against
``sdf_tpu.generate``: the image model of examples/image.py (cut down), a
polygon model, a mesh SDF (the port's tree carrying the JAX package's
grid, via ``load_leaves``) and a legacy numpy closure, with
``sparse=False``, at the defaults and with ``sparse="tiles"``.

Both packages take the same route: at the defaults the cull alone decides
(dense below ``AUTO_TILES_THRESHOLD`` = 0.6 of the batches culled), so
``auto_tiles`` is in both ``LAST_STATS`` or in neither.

Tolerances:
  * float64: canonical soups (rounded to 9 decimals, sorted) equal.  The
    reference's jitted volume differs from the port's by FMA rounding, a
    few ulps, far below the ninth decimal.
  * float32: triangle counts within 1% and every vertex of the port's soup
    within one grid step of a vertex of the reference's: an ulp of a
    sample near zero flips a cell case, which moves a few triangles.
"""

import os

import jax
import numpy as np
import pytest

import sdf_tpu as st
import sdf_torch as sp
from sdf_tpu.core import engine as jengine
from sdf_torch.core import engine as tengine
from sdf_torch.core.node import load_leaves

import torch_helpers as th

FLOWER = os.path.join(os.path.dirname(__file__), "..", "examples",
                      "flower.png")


def _image(m):
    w, h = m.measure_image(FLOWER)
    f = m.rounded_box((w * 1.1, h * 1.1, 0.1), 0.05)
    f |= m.image(FLOWER, pixels=2**12).extrude(1) & m.slab(z0=0, z1=0.075)
    return f


_GRID = {}


def _mesh(m):
    if not _GRID:
        pts, tris = th.sphere_mesh_points()
        _GRID["jax"] = st.Mesh(pts, tris).sdf(voxel_size=0.1, half_width=0.2)
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(_GRID["jax"])]
        _GRID["torch"] = load_leaves(
            sp.Mesh(pts, tris).sdf(voxel_size=0.1, half_width=0.2,
                                   device="cpu"), leaves)
    f = _GRID["jax" if m is st else "torch"]
    return f.erode(0.05).shell(0.1) & m.slab(y0=0)


MODELS = {
    "image": (_image, 2**13),
    "polygon": (th.polygon_model, 2**14),
    "mesh": (_mesh, 2**13),
    "legacy": (lambda m: th.legacy_closure(m) & m.box(1.2), 2**12),
}


def _run(m, name, **kw):
    build, samples = MODELS[name]
    eng = jengine if m is st else tengine
    if m is sp:
        kw["device"] = "cpu"
    pts = np.asarray(m.generate(build(m), samples=samples, verbose=False,
                                **kw))
    return pts, dict(eng.LAST_STATS)


# The reference's tiled path runs a legacy closure through pure_callback
# on several host threads, which aborts the process when torch is loaded
# beside JAX; the port's legacy tiles run is held against its own dense
# run in tests/test_torch_legacy.py instead.
CASES64 = [(name, sparse) for name in sorted(MODELS)
           for sparse in (False, True, "tiles")
           if (name, sparse) != ("legacy", "tiles")]


@pytest.mark.parametrize("name, sparse", CASES64)
def test_float64_soups_equal(name, sparse):
    want, js = _run(st, name, sparse=sparse, dtype=np.float64)
    got, ts = _run(sp, name, sparse=sparse, dtype=np.float64)
    assert len(got) and len(got) == len(want)
    assert th.soup_hash(got) == th.soup_hash(want)
    assert ("auto_tiles" in ts) == ("auto_tiles" in js)
    assert ts["skipped"] == js["skipped"] and ts["batches"] == js["batches"]
    if sparse != "tiles":
        assert ("record_fields" in ts) == ("auto_tiles" not in ts)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_float32_defaults_close(name):
    from scipy.spatial import cKDTree

    want, js = _run(st, name)
    got, ts = _run(sp, name)
    assert ("auto_tiles" in ts) == ("auto_tiles" in js)
    assert abs(len(got) - len(want)) <= 0.01 * len(want)
    (x0, y0, z0), (x1, y1, z1) = tengine._estimate_bounds(
        MODELS[name][0](sp))
    step = ((x1 - x0) * (y1 - y0) * (z1 - z0) / MODELS[name][1]) ** (1 / 3)
    dist, _ = cKDTree(want).query(got)
    assert dist.max() <= step
