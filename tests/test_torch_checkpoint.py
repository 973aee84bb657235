"""sdf_torch.utils.checkpoint: the fingerprint that keys checkpoints and the
engine's memos, and the checkpoint files (exact comparisons throughout)."""

import numpy as np
import pytest
import torch

import sdf_torch as sp
from sdf_torch.core.node import cast
from sdf_torch.utils import checkpoint as ckpt

import torch_helpers as th

X = np.arange(-1.0, 1.0, 0.1)
Y = np.arange(-1.0, 1.0, 0.125)
Z = np.arange(-0.5, 1.0, 0.1)


def _fp(f, extras=True, axes=(X, Y, Z)):
    return ckpt.fingerprint(f, *axes, extras)


def test_equal_models_rebuilt_share_a_key():
    assert _fp(th.example(sp)) == _fp(th.example(sp))
    a = sp.models.knurling()
    b = sp.models.knurling()
    assert a.fn is not b.fn
    assert _fp(a) == _fp(b)
    assert len(_fp(a)) == 64


def test_a_leaf_separates():
    assert _fp(sp.sphere(1.0)) != _fp(sp.sphere(1.0 + 1e-12))
    assert _fp(sp.sphere(1, center=(0, 0, 0.1))) != _fp(sp.sphere(1))
    assert _fp(sp.models.example(hole=0.5)) != _fp(sp.models.example(hole=0.4))


def test_a_closure_static_separates():
    base = sp.cylinder(0.25)
    assert _fp(base.circular_array(4, 1)) != _fp(base.circular_array(12, 1))
    box = sp.box((1, 0.3, 0.3))
    args = ((-0.5, 0, 0), (0.5, 0, 0), (0, 0.2, 0))
    assert _fp(box.bend_linear(*args, sp.ease.in_out_quad)) != _fp(
        box.bend_linear(*args, sp.ease.in_out_cubic))
    assert _fp(sp.sphere(0.1).repeat(0.3, padding=1)) != _fp(
        sp.sphere(0.1).repeat(0.3, padding=2))


def test_k_separates():
    f = lambda k: sp.sphere(1) & sp.box(1.5).k(k)
    assert _fp(f(None)) != _fp(f(0.1))
    assert _fp(f(0.1)) != _fp(f(0.2))
    assert _fp(f(0.1)) == _fp(f(0.1))


def test_the_grid_and_the_extras_separate():
    f = th.example(sp)
    assert _fp(f) != _fp(f, axes=(X, Y, Z + 0.01))
    # boundary-blind concatenation would collide these two
    assert _fp(f, axes=(X[:3], X[3:5], Z)) != _fp(f, axes=(X[:2], X[2:5], Z))
    assert _fp(f, True) != _fp(f, False) != _fp(f, "tiles")
    assert _fp(f, (True, "float32", 32)) != _fp(f, (True, "float64", 32))
    assert _fp(f, (True, "float32", 32)) != _fp(
        f, (True, "float32", 32, "lewiner"))


def test_structure_separates():
    a = sp.sphere(1) & sp.box(1.5)
    assert _fp(a) != _fp(sp.sphere(1) | sp.box(1.5))
    assert _fp(a) != _fp(sp.box(1.5) & sp.sphere(1))


def test_tensor_leaves_hash_like_host_leaves():
    """A cast expression (tensor leaves) hashes its leaves' values and
    dtype: float64 tensors equal the uncast float64 numpy leaves.  (Which
    leaves are one shared object is part of the hash, and cast() gives
    every occurrence its own tensor, so the model here shares none.)"""
    f = sp.sphere(0.7, center=(0.1, 0, 0)) & sp.box((1, 2, 3))
    assert _fp(cast(f, torch.float64, "cpu")) == _fp(f)
    assert _fp(cast(f, torch.float32, "cpu")) != _fp(f)


def test_structure_key_ignores_leaf_values():
    a, b = sp.models.example(hole=0.5), sp.models.example(hole=0.4)
    assert ckpt.structure_key(a) == ckpt.structure_key(b)
    assert ckpt.structure_key(a) != ckpt.structure_key(a, "float64")
    base = sp.cylinder(0.25)
    assert ckpt.structure_key(base.circular_array(4, 1)) != ckpt.structure_key(
        base.circular_array(12, 1))
    assert ckpt.structure_key(sp.sphere(1)) != ckpt.structure_key(sp.box(1))
    assert ckpt.structure_key(sp.sphere(1) & sp.box(1).k(0.1)) != (
        ckpt.structure_key(sp.sphere(1) & sp.box(1)))


def test_save_load_merge(tmp_path):
    pts = np.random.default_rng(0).random((12, 3))
    path = str(tmp_path / "run.ckpt")
    assert ckpt.load(path, "abc") is None  # missing file
    ckpt.save(path, "abc", pts)
    np.testing.assert_array_equal(ckpt.load(path, "abc"), pts)
    assert ckpt.load(path, "abd") is None  # a foreign fingerprint
    other = str(tmp_path / "other.ckpt")
    ckpt.save(other, "x", pts[:6] + 1)
    np.testing.assert_array_equal(
        ckpt.merge([path, other]), np.concatenate([pts, pts[:6] + 1]))
    with open(path, "wb") as fp:
        fp.write(b"not an npz")
    assert ckpt.load(path, "abc") is None  # unreadable: recompute


def test_load_refuses_a_foreign_model(tmp_path):
    path = str(tmp_path / "run.ckpt")
    pts = np.zeros((3, 3))
    ckpt.save(path, _fp(sp.sphere(1)), pts)
    assert ckpt.load(path, _fp(sp.sphere(1))) is not None
    assert ckpt.load(path, _fp(sp.sphere(1.5))) is None


def _gather_leaf_models(other=False):
    """The gather-bearing models' array leaves (polygon vertices, a texture
    array, a mesh grid); with ``other``, other values of the same shapes
    and the same statics."""
    img = np.zeros((24, 32), np.uint8)
    img[6:18, 8:20 + 4 * other] = 255
    pts, tris = th.sphere_mesh_points()
    s = 0.98 if other else 1.0
    return {
        "polygon": sp.polygon(th.polygon_points(0) * s),
        "texture": sp.image(img, width=1.0),
        "mesh": sp.Mesh(pts * s, tris).sdf(voxel_size=0.25, device="cpu"),
    }


@pytest.mark.parametrize("name", ["polygon", "texture", "mesh"])
def test_gather_leaves_key_the_memos(name):
    """Texture arrays, mesh grids and polygon vertices are parameter leaves:
    a rebuilt model shares its fingerprint and structure key, other values
    of the same shape change the fingerprint and not the structure key."""
    a = _gather_leaf_models()[name]
    b = _gather_leaf_models()[name]
    c = _gather_leaf_models(other=True)[name]
    assert _fp(a) == _fp(b) and _fp(a) != _fp(c)
    assert ckpt.structure_key(a) == ckpt.structure_key(b)
    assert ckpt.structure_key(a) == ckpt.structure_key(c)


def test_legacy_closure_has_no_fingerprint():
    f = th.legacy_closure(sp) | sp.sphere(0.5)
    with pytest.raises(ValueError, match="no fingerprint"):
        _fp(f)
    assert sp.core.engine._fingerprint_or_none(f, X, Y, Z, "x") is None
