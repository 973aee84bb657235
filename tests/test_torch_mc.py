"""Marching cubes: ntri (kernel B3), count and indexed emit (kernels B4, B5
inside), against the JAX package fed the same volume.

Tolerance: every integer output bit-equal; float outputs (vertex t,
positions) bit-equal too, because both sides compute them from the same
volume with the same IEEE ops.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
from sdf_tpu.core import engine as jengine
from sdf_tpu.core import mc as jmc
from sdf_tpu.core.node import cast as jcast
from sdf_torch.core import mc as tmc

import torch_helpers as th

TILE = 4


def test_ntri_matches_pallas_interpret():
    """All 256 codes, a ragged tail of random codes, and codes outside the
    table (0, like the one-hot form)."""
    rng = np.random.default_rng(0)
    codes = np.concatenate(
        [np.arange(256), rng.integers(0, 256, 1237), [256, 4095, -1, -300]]
    ).astype(np.int32)
    want = np.asarray(jmc._ntri_of_kernel(jnp.asarray(codes), "default",
                                          _interpret=True))
    got = tmc.ntri_of(torch.as_tensor(codes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the grid-shaped form keeps its shape
    grid = codes[:1000].reshape(10, 10, 10)
    np.testing.assert_array_equal(
        tmc.ntri_of(torch.as_tensor(grid)).numpy(), want[:1000].reshape(10, 10, 10)
    )


def _volume(dtype):
    """A small f32/f64 volume of the example model from the JAX package,
    plus a random tile cull mask."""
    jd = getattr(jnp, dtype)
    X = np.arange(-1.0, 1.0, 0.09)
    Y = np.arange(-1.05, 1.0, 0.1)
    Z = np.arange(-0.95, 1.0, 0.085)
    vol = np.array(jengine._eval_volume(jcast(th.example(st), jd), X, Y, Z, jd))
    cshape = tuple(n - 1 for n in vol.shape)
    tshape = tuple(-(-c // TILE) for c in cshape)
    skip = np.random.default_rng(1).random(tshape) < 0.2
    keep = np.repeat(np.repeat(np.repeat(~skip, TILE, 0), TILE, 1), TILE, 2)
    keep = keep[: cshape[0], : cshape[1], : cshape[2]]
    return vol, keep, tshape


def _both_counts(vol, keep, tshape):
    jv = jnp.asarray(vol)
    jcase = jmc._cell_cases(jv)
    want = jmc.count_indexed(jv, jcase, jnp.asarray(keep), TILE, tshape)
    tv = torch.as_tensor(vol)
    tcase = tmc._cell_cases(tv)
    got = tmc.count_indexed(tv, tcase, torch.as_tensor(keep), TILE, tshape)
    return (jv, jcase, want), (tv, tcase, got)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_count_indexed_matches(dtype):
    vol, keep, tshape = _volume(dtype)
    (_, _, want), (_, _, got) = _both_counts(vol, keep, tshape)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(torch.as_tensor(g).numpy(), np.asarray(w))


@pytest.mark.parametrize(
    "dtype,packed", [("float64", False), ("float32", True), ("float32", "wide")]
)
def test_gather_emit_indexed_matches(dtype, packed):
    vol, keep, tshape = _volume(dtype)
    (jv, jcase, want), (tv, tcase, got) = _both_counts(vol, keep, tshape)
    n_cells, n, ne = (int(x) for x in want[:3])
    caps = (jmc.round_capacity(ne), jmc.round_capacity(n),
            jmc.round_capacity(n_cells))
    we, wf = jmc.gather_emit_indexed(jv, jcase, want[4], want[5], *caps,
                                     packed=packed)
    ge, gf = tmc.gather_emit_indexed(tv, tcase, got[4], got[5], *caps,
                                     packed=packed)
    we, wf = np.asarray(we), np.asarray(wf)
    ge, gf = ge.numpy(), gf.numpy()
    if packed is False:
        # (3, edge_capacity) float vertices and (3, capacity) int32 faces
        np.testing.assert_array_equal(ge, we)
        np.testing.assert_array_equal(gf, wf)
        return
    # int32 bit patterns of the JAX package's uint32 wire arrays
    np.testing.assert_array_equal(ge.view(np.uint32), we)
    np.testing.assert_array_equal(gf.view(np.uint32), wf)
    # decode: bit-equal to the JAX package's decoder on its own arrays
    want_v, want_f = jmc.unpack_indexed(we[:, :ne], wf[:, :n], vol.shape)
    got_v, got_f = tmc.unpack_indexed(ge.view(np.uint32)[:, :ne],
                                      gf.view(np.uint32)[:, :n], vol.shape)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)


@pytest.mark.parametrize("branch", [0, 1, 2])
def test_resolve_faces_branches_agree(monkeypatch, branch):
    """The three per-triangle cell lookups of _resolve_faces give the JAX
    package's faces (its grid picks branch 0; the others are forced)."""
    vol, keep, tshape = _volume("float64")
    (jv, jcase, want), (tv, tcase, got) = _both_counts(vol, keep, tshape)
    n_cells, n, ne = (int(x) for x in want[:3])
    caps = (jmc.round_capacity(ne), jmc.round_capacity(n),
            jmc.round_capacity(n_cells))
    _, wf = jmc.gather_emit_indexed(jv, jcase, want[4], want[5], *caps)
    monkeypatch.setattr(tmc, "_face_branch", lambda ncells, cbits: branch)
    _, gf = tmc.gather_emit_indexed(tv, tcase, got[4], got[5], *caps)
    np.testing.assert_array_equal(gf.numpy()[:, :n], np.asarray(wf)[:, :n])


def test_unpack_faces_bit_equal():
    rng = np.random.default_rng(3)
    f = rng.integers(0, 2**21, (3, 500)).astype(np.uint32)
    B = tmc.FACE_PACK_BITS
    w0 = (f[0] | ((f[1] & ((1 << (32 - B)) - 1)) << B)).astype(np.uint32)
    w1 = ((f[1] >> (32 - B)) | (f[2] << (2 * B - 32))).astype(np.uint32)
    packed = np.stack([w0, w1])
    np.testing.assert_array_equal(tmc.unpack_faces(packed), jmc.unpack_faces(packed))
    np.testing.assert_array_equal(tmc.unpack_faces(packed), f.T.astype(np.int32))
    np.testing.assert_array_equal(tmc.unpack_faces(f), jmc.unpack_faces(f))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_emit_indexed_z_offset_matches(dtype):
    """emit_indexed(z_offset=): the JAX package's vertices and faces, bit
    for bit; the offset goes into the integer z before the float add, so a
    slab of a grid emits the vertices of the whole grid's run."""
    vol, keep, tshape = _volume(dtype)
    (jv, jcase, want), (tv, tcase, got) = _both_counts(vol, keep, tshape)
    n_cells, n, ne = (int(x) for x in want[:3])
    caps = (jmc.round_capacity(ne), jmc.round_capacity(n),
            jmc.round_capacity(n_cells))
    jstate = jmc.compact_cells(jcase, want[4], caps[2])
    tstate = tmc.compact_cells(tcase, got[4], caps[2])
    for off in (0, 7):
        we, wf, wn = jmc.emit_indexed(jv, want[5], jstate, *caps, z_offset=off)
        ge, gf, gn = tmc.emit_indexed(tv, got[5], tstate, *caps, z_offset=off)
        np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
        np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
        assert int(gn) == int(wn) == n
    # The cells of z slab [3, 10] of the grid, offset by 3: the whole
    # grid's vertices of those cells, bit for bit.
    slab = tv[:, :, 3:11].contiguous()
    scase = tcase[:, :, 3:10].contiguous()
    active = got[4][:, :, 3:10].contiguous()
    emask = tmc._edge_mask(slab, active)
    sn = int((tmc.ntri_of(scase) * active).sum())
    sne = int(emask.sum())
    state = tmc.compact_cells(scase, active, caps[2])
    se, sf, _ = tmc.emit_indexed(slab, emask, state, caps[0], caps[1],
                                 caps[2], z_offset=3)
    soup = se.numpy()[:, :sne].T[sf.numpy()[:, :sn].T.reshape(-1)]
    ge, gf, _ = tmc.emit_indexed(tv, got[5], tstate, *caps)
    whole = ge.numpy()[:, :ne].T[gf.numpy()[:, :n].T.reshape(-1)].reshape(
        -1, 3, 3)
    z = whole[:, :, 2].min(axis=1)
    inside = whole[(z >= 3) & (z < 10)]
    assert len(soup) > 0
    assert np.array_equal(th.canon(soup), th.canon(inside))
