"""The tiled sparse path: ``sdf_torch.core.sparse`` and the plain versions
of kernels B6 and B7 against ``sdf_tpu`` on JAX-CPU.

Tolerances:
  * integer stages fed the same tile volumes (case codes of both variants,
    the cell and edge masks, every count, faces in all three packings and
    both face branches, the host decode): bit-equal, padding included.
  * ``everts``: bit-equal (one division and one clamp per vertex; the
    ``base + t * mask`` sum rounds the same with or without contraction).
  * tile volumes: bit-equal to EAGER JAX (``jax.disable_jit()``), within 8
    eps of jitted JAX and of the Pallas kernels in interpret mode (jitted
    XLA on the CPU contracts multiply-adds, the port never does); the
    kernels' case codes equal the port's wherever all eight corner signs of
    the two volumes agree.
  * whole pipeline, float64: triangle counts equal and canonical soups
    (rounded to 9 decimals, lexsorted) equal.

The JAX reference runs on a 1-device mesh (tests/conftest.py gives JAX
eight virtual devices, and with more than one generate() shards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
import sdf_torch as sp
from sdf_tpu.core import pallas_eval
from sdf_tpu.core import sparse as jsparse
from sdf_tpu.core.node import cast as jcast
from sdf_tpu.models import zoo as jzoo
from sdf_tpu.parallel import grid as pgrid
from sdf_torch.core import engine as tengine
from sdf_torch.core import eval_classify as ec
from sdf_torch.core import hybrid
from sdf_torch.core import mc as tmc
from sdf_torch.core import node as tnode
from sdf_torch.core import sparse as tsparse
from sdf_torch.models import zoo as tzoo

import torch_helpers as th

VARIANTS = ["default", "lewiner"]
MODELS = {
    "example": (th.example, th.example),
    "blobby": (lambda m: jzoo.blobby(), lambda m: tzoo.blobby()),
    "knurling": (lambda m: jzoo.knurling(), lambda m: tzoo.knurling()),
}


@pytest.fixture(autouse=True)
def _fresh_memos():
    for memo in (tengine._BOUNDS_MEMO, tengine._COUNTS_MEMO,
                 tengine._SKIP_MEMO, tsparse._COUNTS_MEMO):
        memo.clear()


def _tile_inputs(seed, n=27, tile=8, dtype=np.float32, keep=0.7):
    """Tile volumes cut from a noisy sphere field on an ``n^3`` grid (the
    noise makes ambiguous cells), a random share of the tiles kept, padded
    to round_capacity with tile 0: ``(vols, tiles, live, cshape, nt)``."""
    rng = np.random.default_rng(seed)
    lin = np.linspace(-1.2, 1.2, n)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    vol = np.sqrt(x * x + y * y + z * z) - 0.9 + 0.08 * rng.normal(size=x.shape)
    active = th.grid_tiles((n, n, n), tile, rng, keep)
    nt = len(active)
    ntc = tmc.round_capacity(nt)
    tiles = np.zeros((ntc, 3), np.int32)
    tiles[:nt] = active
    live = np.zeros(ntc, bool)
    live[:nt] = True
    ar = np.arange(tile + 1)
    vols = np.stack([
        vol[np.ix_(*[np.clip(t[a] * tile + ar, 0, n - 1) for a in range(3)])]
        for t in tiles
    ]).astype(dtype)
    return vols, tiles, live, (n - 1,) * 3, nt


def _jax_counts(vols, tiles, live, cshape, tile, variant):
    """The reference's count outputs; lewiner codes from eager JAX (the
    jitted classify contracts multiply-adds)."""
    case = None
    if variant != "default":
        with jax.disable_jit():
            case = jsparse._tile_cases(jnp.asarray(vols), tile, variant)
    return jsparse._count_tiles(jnp.asarray(vols), jnp.asarray(tiles),
                                jnp.asarray(live), cshape, tile, case, variant)


# --- integer stages -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_tile_cases_match_jax(variant, dtype):
    vols, *_ = _tile_inputs(1, dtype=getattr(np, dtype))
    with jax.disable_jit():
        want = jsparse._tile_cases(jnp.asarray(vols), 8, variant)
    got = tsparse._tile_cases(torch.as_tensor(vols), 8, variant)
    assert got.dtype == torch.int32 and got.shape == (len(vols), 8, 8, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cell_valid_and_edge_mask_match_jax():
    vols, tiles, live, cshape, _ = _tile_inputs(2)
    valid_j = jsparse._cell_valid(jnp.asarray(tiles), jnp.asarray(live),
                                  cshape, 8)
    valid_t = tsparse._cell_valid(torch.as_tensor(tiles),
                                  torch.as_tensor(live), cshape, 8)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    assert not valid_t.all() and valid_t.any()  # edge tiles and dead rows
    active = np.random.default_rng(3).random(valid_t.shape) < 0.3
    mask_j = jsparse._tile_edge_mask(jnp.asarray(vols), jnp.asarray(active), 8)
    mask_t = tsparse._tile_edge_mask(torch.as_tensor(vols),
                                     torch.as_tensor(active), 8)
    assert mask_t.shape == (len(vols), 3 * 8 * 9 * 9)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))


@pytest.mark.parametrize("variant", VARIANTS)
def test_count_tiles_match_jax(variant):
    vols, tiles, live, cshape, _ = _tile_inputs(4)
    want = _jax_counts(vols, tiles, live, cshape, 8, variant)
    got = tsparse._count_tiles(
        torch.as_tensor(vols), torch.as_tensor(tiles), torch.as_tensor(live),
        cshape, 8, None, variant)
    assert int(want[0]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _emit_pair(vols, tiles, live, cshape, tile, variant, packed):
    total, _, ncell, case, nedge, emask = _jax_counts(
        vols, tiles, live, cshape, tile, variant)
    n, ncl, ne = int(total), int(ncell), int(nedge)
    caps = tuple(tmc.round_capacity(v) for v in (ne, n, ncl))
    want = jsparse._emit_tiles_indexed(
        jnp.asarray(vols), jnp.asarray(tiles), jnp.asarray(live), case, emask,
        cshape, *caps, tile, packed=packed, variant=variant)
    got = tsparse._emit_tiles_indexed(
        torch.as_tensor(vols), torch.as_tensor(tiles), torch.as_tensor(live),
        torch.as_tensor(np.array(case)), torch.as_tensor(np.array(emask)),
        cshape, *caps, tile, packed=packed, variant=variant)
    return got, want, (n, ncl, ne), (case, caps)


@pytest.mark.parametrize("packed", [False, True, "wide"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_emit_tiles_indexed_match_jax(variant, packed):
    """Vertices and faces bit-equal in every packing, padding included, and
    the host decode of the packed forms equal to the reference's."""
    vols, tiles, live, cshape, _ = _tile_inputs(5)
    got, want, (n, _, ne), _ = _emit_pair(vols, tiles, live, cshape, 8,
                                          variant, packed)
    ev, fa = got[0].numpy(), got[1].numpy()
    if packed is not False:
        ev, fa = ev.view(np.uint32), fa.view(np.uint32)
    assert int(got[2]) == int(want[2]) == n
    np.testing.assert_array_equal(ev, np.asarray(want[0]))
    np.testing.assert_array_equal(fa, np.asarray(want[1]))
    assert fa.shape[0] == (2 if packed is True else 3)
    if packed is not False:
        vj, fj = jsparse.unpack_tiles_indexed(
            np.asarray(want[0])[:, :ne], np.asarray(want[1])[:, :n], tiles, 8)
        vt, ft = tsparse.unpack_tiles_indexed(ev[:, :ne], fa[:, :n], tiles, 8)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(ft, fj)
        assert ft.dtype == np.int32 and vt.dtype == np.float64


@pytest.mark.parametrize("variant", VARIANTS)
def test_indexed_emit_gathers_to_the_reference_soup(variant):
    """``everts[faces]`` is the reference's tile soup (``_emit_tiles``) bit
    for bit, in (tile, cell) order; the packed forms decode to the same."""
    vols, tiles, live, cshape, _ = _tile_inputs(6)
    got, _, (n, ncl, ne), (case, caps) = _emit_pair(
        vols, tiles, live, cshape, 8, variant, False)
    verts9, n_tris = jsparse._emit_tiles(
        jnp.asarray(vols), jnp.asarray(tiles), jnp.asarray(live), case, cshape,
        caps[1], caps[2], 8, variant)
    soup = np.asarray(verts9[:, :n]).T.reshape(-1, 3)
    vh = got[0].numpy()[:, :ne].T
    fh = got[1].numpy()[:, :n].T
    assert int(n_tris) == n
    np.testing.assert_array_equal(vh[fh.reshape(-1)], soup)
    for packed in (True, "wide"):
        (ep, fp, _), *_ = _emit_pair(vols, tiles, live, cshape, 8, variant,
                                     packed)
        v2, f2 = tsparse.unpack_tiles_indexed(
            ep.numpy().view(np.uint32)[:, :ne],
            fp.numpy().view(np.uint32)[:, :n], tiles, 8)
        np.testing.assert_array_equal(v2, vh.astype(np.float64))
        np.testing.assert_array_equal(f2, fh)


def test_word_pack_bound_follows_case_bits():
    """The (cell, case) word of face resolution fits int32 while tile^3 <<
    case_bits <= 2^31: to tile 203 with 8-bit codes, to tile 64 with
    lewiner's 13 bits (not 80, as a 12-bit count would give)."""
    bits = {v: tmc.get_tables(v).case_bits for v in VARIANTS}
    assert bits == {"default": 8, "lewiner": 13}
    assert tsparse._word_pack_fits(203, 8) and not tsparse._word_pack_fits(204, 8)
    assert tsparse._word_pack_fits(64, 13) and not tsparse._word_pack_fits(65, 13)


def test_large_tile_face_branch_matches_jax():
    """One lewiner tile of 65 cells takes the staging-gather branch in both
    packages (65^3 << 13 > 2^31): faces and vertices bit-equal."""
    tile = 65
    rng = np.random.default_rng(8)
    lin = np.linspace(-1.2, 1.2, 19)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    vol = np.sqrt(x * x + y * y + z * z) - 0.9 + 0.08 * rng.normal(size=x.shape)
    ix = np.clip(np.arange(tile + 1), 0, 18)
    vols = vol[np.ix_(ix, ix, ix)][None].astype(np.float32)
    tiles = np.zeros((1, 3), np.int32)
    live = np.ones(1, bool)
    got, want, (n, _, ne), _ = _emit_pair(vols, tiles, live, (18,) * 3, tile,
                                          "lewiner", False)
    assert n > 0 and int(got[2]) == n
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    fh = got[1].numpy()[:, :n]
    assert fh.min() >= 0 and fh.max() < ne


@pytest.mark.parametrize("variant", VARIANTS)
def test_face_branches_agree(variant, monkeypatch):
    """The staging-gather branch gives the faces of the word-pack branch."""
    vols, tiles, live, cshape, _ = _tile_inputs(9)
    a, *_ = _emit_pair(vols, tiles, live, cshape, 8, variant, False)
    monkeypatch.setattr(tsparse, "_word_pack_fits", lambda tile, cbits: False)
    b, *_ = _emit_pair(vols, tiles, live, cshape, 8, variant, False)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


def test_emit_refuses_edge_ids_past_int32():
    tile = 32
    ntc = 2**31 // (3 * tile * 33 * 33) + 1
    vols = torch.zeros((ntc, 1), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="int32"):
        tsparse._emit_tiles_indexed(vols, None, None, None, None, (1, 1, 1),
                                    1, 1, 1, tile)


# --- tile volumes: the plain versions of B6 and B7 -------------------------------


def _model_grid(name, n=21):
    lo = {"example": -1.05, "blobby": -4.0, "knurling": -3.0}[name]
    X = np.linspace(lo, -lo, n)
    return X, X * 0.97, X * 1.01


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("model", ["example", "blobby"])
def test_eval_tiles_match_jax(model, dtype):
    """Bit-equal to eager JAX, within 8 eps of jitted JAX; edge tiles clamp
    and padded rows repeat tile 0."""
    X, Y, Z = _model_grid(model)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tiles = th.grid_tiles((21,) * 3, 8, np.random.default_rng(0), 0.6)
    tiles = np.concatenate([tiles, np.zeros((2, 3), np.int32)])
    fj, ft = (b(m) for b, m in zip(MODELS[model], (st, sp)))
    args = (jcast(fj, jd), jnp.asarray(X, jd), jnp.asarray(Y, jd),
            jnp.asarray(Z, jd), jnp.asarray(tiles), len(tiles), 4, 8)
    jitted = np.asarray(jsparse._eval_tiles(*args))
    with jax.disable_jit():
        eager = np.asarray(jsparse._eval_tiles(*args))
    got = tsparse._eval_tiles(ft, X, Y, Z, torch.as_tensor(tiles), 8, td,
                              chunk=5)
    assert got.shape == (len(tiles), 9, 9, 9) and got.dtype == td
    np.testing.assert_array_equal(got.numpy(), eager)
    scale = max(1.0, float(np.abs(eager).max()))
    np.testing.assert_allclose(got.numpy(), jitted, rtol=0,
                               atol=8 * np.finfo(dtype).eps * scale)
    assert torch.equal(got[-1], got[-2])  # the padded rows are tile 0 twice


def _signs_agree(va, vb):
    """Cells whose eight corner signs are the same in both tile volumes."""
    same = (np.asarray(va) < 0) == (np.asarray(vb) < 0)
    t = same.shape[1] - 1
    ok = np.ones((len(same), t, t, t), bool)
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                ok &= same[:, ox: t + ox, oy: t + oy, oz: t + oz]
    return ok


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("model", ["example", "blobby"])
def test_batched_kernel_contract_matches_pallas_interpret(model, dtype):
    """Kernel B6's contract: the port's plain pair against the JAX package's
    lane-major tile kernel in interpret mode."""
    X, Y, Z = _model_grid(model)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tiles = th.grid_tiles((21,) * 3, 8, np.random.default_rng(1), 0.5)
    fj, ft = (b(m) for b, m in zip(MODELS[model], (st, sp)))
    vj, cj = pallas_eval.eval_tiles_and_classify_batched(
        jcast(fj, jd), jnp.asarray(X, jd), jnp.asarray(Y, jd),
        jnp.asarray(Z, jd), jnp.asarray(tiles), len(tiles), 8, interpret=True)
    vt, ct = ec.eval_tiles_and_classify_batched(
        ft, X, Y, Z, torch.as_tensor(tiles), 8, td)
    assert ct.dtype == torch.int32 and ct.shape == (len(tiles), 8, 8, 8)
    scale = max(1.0, float(np.abs(np.asarray(vj)).max()))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=8 * np.finfo(dtype).eps * scale)
    ok = _signs_agree(vt.numpy(), vj)
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(ct.numpy()[ok], np.asarray(cj)[ok])


def _padded(A, tile):
    return np.concatenate([A, np.full(tile, A[-1])])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_per_tile_kernel_contract_matches_pallas_interpret(dtype):
    """Kernel B7's contract without fields: padded axes, no clamp; equal to
    the B6 contract on the same tiles, and to the JAX package's per-tile
    kernel in interpret mode."""
    X, Y, Z = _model_grid("example")
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tiles = th.grid_tiles((21,) * 3, 8, np.random.default_rng(2), 0.5)
    Xp, Yp, Zp = (_padded(A, 8) for A in (X, Y, Z))
    vj, cj = pallas_eval.eval_tiles_and_classify(
        jcast(th.example(st), jd), jnp.asarray(Xp, jd), jnp.asarray(Yp, jd),
        jnp.asarray(Zp, jd), jnp.asarray(tiles), len(tiles), 8, interpret=True)
    tt = torch.as_tensor(tiles)
    vt, ct = ec.eval_tiles_and_classify(th.example(sp), Xp, Yp, Zp, tt, 8, td)
    vb, cb = ec.eval_tiles_and_classify_batched(th.example(sp), X, Y, Z, tt,
                                                8, td)
    assert torch.equal(vt, vb) and torch.equal(ct, cb)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=8 * np.finfo(dtype).eps)
    ok = _signs_agree(vt.numpy(), vj)
    np.testing.assert_array_equal(ct.numpy()[ok], np.asarray(cj)[ok])


# --- the gather-marked test op through hybrid -------------------------------------


def _jax_table_field(table, lo=-1.5, hi=1.5):
    """th.table_field in the JAX package."""
    from sdf_tpu.core import hybrid as jhybrid
    from sdf_tpu.core.node import SDF3 as JSDF3

    n = len(table)

    @jhybrid.mark_gather
    def fn(q, p):
        x, z = p[0], p[2]
        i = jnp.clip(jnp.round((x - lo) * ((n - 1) / (hi - lo))), 0, n - 1)
        return z - q["table"][i.astype(jnp.int32)]

    return JSDF3(fn, {"table": jnp.asarray(table)})


@pytest.mark.parametrize("name, nf", [("rotated", 1), ("circular", 2)])
def test_hybrid_fields(name, nf):
    """Fields are recorded at the transformed points their subtree sees (a
    parent that evaluates its child twice records two), the kernel tree
    reads them in order, and the result is the whole expression's, bit for
    bit."""
    f = th.gather_models(sp)[name]
    assert hybrid.count_gathers(f) == 1
    assert hybrid.count_gathers(th.example(sp)) == 0
    tile, td = 8, torch.float64
    X = _padded(np.linspace(-1.3, 1.3, 33), tile)
    tiles = torch.as_tensor(th.grid_tiles((33,) * 3, tile,
                                          np.random.default_rng(3), 0.4))
    axes = ec._axes(X, X, X, td, "cpu")
    fields = hybrid.record_tiles(f, *axes, tiles, tile)
    assert len(fields) == nf
    assert all(fl.shape == (len(tiles), 9, 9, 9) for fl in fields)
    tree = hybrid.to_kernel_tree(f)
    assert hybrid.count_gathers(tree) == 0
    whole = ec._eval_tiles(f, X, X, X, tiles, tile, td, clamp=False)
    split = ec._eval_tiles(tree, X, X, X, tiles, tile, td, clamp=False,
                           fields=fields, chunk=7)
    assert torch.equal(split, whole)
    vols, case = ec.eval_tiles_and_classify(f, X, X, X, tiles, tile, td)
    assert torch.equal(vols, whole) and torch.equal(case, tmc._cell_cases(whole))
    if name == "rotated":
        # the field is the lookup at ROTATED points, not at the grid's own
        sub = f.params["bs"][0]  # the rotated lookup under the intersection
        direct = ec._eval_tiles(sub, X, X, X, tiles, tile, td, clamp=False)
        assert torch.equal(fields[0], direct)
        plain = th.table_field(0.25 * np.cos(np.linspace(0.0, 9.0, 25)))
        unrotated = ec._eval_tiles(plain, X, X, X, tiles, tile, td, clamp=False)
        assert not torch.equal(fields[0], unrotated)
    with pytest.raises(RuntimeError, match="kernel_fields"):
        tree(np.zeros((2, 3)), device="cpu")
    with pytest.raises(ValueError, match="gather"):
        ec.eval_tiles_and_classify_batched(f, X, X, X, tiles, tile, td)
    # The dense kernel's source of the raw expression reads the same fields
    # through the same placeholders.
    src = ec.kernel_source(f)
    assert "F.p[%d][fi]" % (nf - 1) in src and src == ec.kernel_source(tree, nf)


def test_hybrid_matches_jax_per_tile_kernel():
    """The same gather-marked op in both packages: the port's B7 plain
    version against the JAX package's hybrid per-tile kernel (interpret)."""
    table = 0.25 * np.cos(np.linspace(0.0, 9.0, 25))
    fj = st.sphere(1.2) & _jax_table_field(table).rotate(0.5, st.X)
    ft = th.gather_models(sp)["rotated"]
    X = _padded(np.linspace(-1.3, 1.3, 25), 8)
    tiles = th.grid_tiles((25,) * 3, 8, np.random.default_rng(4), 0.5)
    vj, cj = pallas_eval.eval_tiles_and_classify(
        jcast(fj, jnp.float64), *[jnp.asarray(X)] * 3, jnp.asarray(tiles),
        len(tiles), 8, interpret=True)
    vt, ct = ec.eval_tiles_and_classify(ft, X, X, X, torch.as_tensor(tiles), 8,
                                        torch.float64)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=8 * np.finfo(np.float64).eps)
    ok = _signs_agree(vt.numpy(), vj)
    np.testing.assert_array_equal(ct.numpy()[ok], np.asarray(cj)[ok])


@pytest.mark.parametrize("model", ["example", "blobby", "rotated", "circular"])
def test_generated_tile_body_equals_torch(model):
    """The per-point body generated for kernels B6 and B7 (interpreted with
    numpy) equals the plain tile volumes bit for bit, in both dtypes; field
    placeholders read their field at the point's own index."""
    tile = 8
    if model in MODELS:
        f, nf, fields_of = MODELS[model][1](sp), 0, None
        X, Y, Z = (_padded(A, tile) for A in _model_grid(model))
    else:
        f, nf = th.gather_models(sp)[model], 1 + (model == "circular")
        X = Y = Z = _padded(np.linspace(-1.3, 1.3, 21), tile)
    tiles = torch.as_tensor(th.grid_tiles((21,) * 3, tile,
                                          np.random.default_rng(5), 0.3))
    tree = hybrid.to_kernel_tree(f)
    src = ec.tile_kernel_source(tree, nf)
    for entry in ("sdf_eval_tiles_f32", "sdf_eval_tiles_f64",
                  "sdf_eval_tiles_fields_f32", "sdf_eval_tiles_fields_f64"):
        assert entry in src
    assert src.count(" = F.p[") == nf  # one read per recorded field
    assert '#include "sdf_point.cuh"' not in src
    for td, nd in ((torch.float32, np.float32), (torch.float64, np.float64)):
        want, _ = ec.eval_tiles_and_classify(f, X, Y, Z, tiles, tile, td)
        fields = hybrid.record_tiles(f, *ec._axes(X, Y, Z, td, "cpu"), tiles,
                                     tile) if nf else ()
        P = ec._flat_params(tree, td, "cpu").numpy()
        idx = tiles.numpy().astype(np.int64)[:, :, None] * tile + np.arange(
            tile + 1)
        x, y, z = (A.astype(nd)[idx[:, a]] for a, A in enumerate((X, Y, Z)))
        got = th.run_body(src, x[:, :, None, None], y[:, None, :, None],
                          z[:, None, None, :], P,
                          fields=[fl.numpy() for fl in fields])
        np.testing.assert_array_equal(np.broadcast_to(got, want.shape),
                                      want.numpy())


def test_tile_source_counts_its_fields():
    f = th.gather_models(sp)["circular"]
    tree = hybrid.to_kernel_tree(f)
    with pytest.raises(ValueError, match="field inputs"):
        ec.tile_kernel_source(tree, 1)  # it reads two
    with pytest.raises(ValueError, match="at most"):
        ec.tile_kernel_source(tree, ec.MAX_FIELDS + 1)
    # the same structure with another table reuses the source
    other = sp.sphere(1.0) & th.table_field(np.zeros(25)).translate(
        (0.1, 0.0, 0.0)).circular_array(3, 0.0)
    assert ec.tile_kernel_source(hybrid.to_kernel_tree(other), 2) == \
        ec.tile_kernel_source(tree, 2)


# --- live: the padded rows of a tile list are copies ----------------------------


def _same_bits(a, b):
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    if a.dtype in ints:
        a, b = a.view(ints[a.dtype]), b.view(ints[b.dtype])
    return torch.equal(a, b)


def _padded_list(tiles, pad):
    """``tiles`` followed by ``pad`` rows of tile 0, as mesh_sparse_tiles
    pads its list."""
    return torch.as_tensor(np.concatenate([tiles, np.zeros((pad, 3),
                                                           np.int32)]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", ["example", "blobby"])
def test_batched_wrapper_with_live_equals_every_row(model, dtype):
    """Kernel B6's wrapper with ``live``: the first padded row evaluated,
    a later one, and none padded; the outputs are bit-equal to those of
    ``live=None``, every padded row included."""
    X, Y, Z = _model_grid(model)
    t = th.grid_tiles((21,) * 3, 8, np.random.default_rng(6), 0.5)
    tiles = _padded_list(t, 5)
    f = MODELS[model][1](sp)
    want = ec.eval_tiles_and_classify_batched(f, X, Y, Z, tiles, 8, dtype)
    for live in (len(t), len(t) + 3, len(tiles)):
        got = ec.eval_tiles_and_classify_batched(f, X, Y, Z, tiles, 8, dtype,
                                                 live=live)
        assert _same_bits(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="live"):
        ec.eval_tiles_and_classify_batched(f, X, Y, Z, tiles, 8, dtype,
                                           live=len(tiles) + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name, nf", [("rotated", 1), ("circular", 2)])
def test_per_tile_wrapper_records_and_evaluates_the_live_rows(name, nf, dtype,
                                                              monkeypatch):
    """Kernel B7's wrapper with ``live``: the pre-pass records the fields of
    min(live + 1, ntc) rows only, and the outputs are bit-equal to those
    of ``live=None``."""
    f = th.gather_models(sp)[name]
    tile = 8
    X = _padded(np.linspace(-1.3, 1.3, 33), tile)
    t = th.grid_tiles((33,) * 3, tile, np.random.default_rng(3), 0.4)
    tiles = _padded_list(t, 4)
    recorded = []
    real = hybrid.record_tiles
    monkeypatch.setattr(hybrid, "record_tiles",
                        lambda *a: recorded.append(real(*a)) or recorded[-1])
    want = ec.eval_tiles_and_classify(f, X, X, X, tiles, tile, dtype)
    got = ec.eval_tiles_and_classify(f, X, X, X, tiles, tile, dtype,
                                     live=len(t))
    assert [fl.shape[0] for fl in recorded[0]] == [len(tiles)] * nf
    assert [fl.shape[0] for fl in recorded[1]] == [len(t) + 1] * nf
    assert _same_bits(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("gather", [False, True])
def test_mesh_sparse_tiles_passes_live(gather, monkeypatch):
    """mesh_sparse_tiles hands its live count to the eval wrapper, and the
    mesh equals the one from evaluating every padded row."""
    f = th.gather_models(sp)["rotated"] if gather else th.example(sp)
    name = ("eval_tiles_and_classify" if gather
            else "eval_tiles_and_classify_batched")
    X = np.linspace(-1.3, 1.3, 30)
    skip = tengine._skip_mask(f, X, X, X, 8, torch.float32)
    nt = int((~skip).sum())
    assert tmc.round_capacity(nt) > nt  # the list is padded
    real, seen = getattr(ec, name), []

    def spy(*a, live=None):
        seen.append((a[4].shape[0], live))
        return real(*a, live=live)

    monkeypatch.setattr(ec, name, spy)
    got = tsparse.mesh_sparse_tiles(f, X, X, X, skip, 8, torch.float32, "cpu")
    assert seen == [(tmc.round_capacity(nt), nt)]
    monkeypatch.setattr(ec, name, lambda *a, live=None: real(*a))
    want = tsparse.mesh_sparse_tiles(f, X, X, X, skip, 8, torch.float32,
                                     "cpu")
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], want[1])


# --- the whole pipeline -------------------------------------------------------------


def _jax_generate(f, **kw):
    return f.generate(verbose=False, mesh=pgrid.make_mesh(jax.devices()[:1]),
                      **kw)


@pytest.mark.parametrize("variant", ["lewiner", "fast"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_generate_tiles_f64_matches_jax(model, variant):
    fj, ft = (b(m) for b, m in zip(MODELS[model], (st, sp)))
    kw = dict(samples=2**13, batch_size=4, sparse="tiles", mc_variant=variant)
    want = _jax_generate(fj, dtype=jnp.float64, **kw)
    got = sp.generate(ft, verbose=False, dtype=torch.float64, device="cpu",
                      **kw)
    assert len(got) // 3 == len(want) // 3 > 0
    assert th.soup_hash(got) == th.soup_hash(want)
    # knurling fills its box: the cull keeps every batch at this size
    assert (tengine.LAST_STATS["skipped"] > 0) == (model != "knurling")
    assert "sparse_tiles" in tengine.LAST_STATS


def test_generate_tiles_f32_matches_jax():
    kw = dict(samples=2**13, batch_size=8, sparse="tiles")
    want = _jax_generate(th.example(st), dtype=jnp.float32, **kw)
    got = sp.generate(th.example(sp), verbose=False, device="cpu", **kw)
    assert len(got) == len(want)
    a, b = (np.asarray(p).reshape(-1, 9) for p in (got, want))
    a, b = a[np.lexsort(a.round(4).T[::-1])], b[np.lexsort(b.round(4).T[::-1])]
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("model", ["example", "sphere"])
def test_tiles_equal_dense_on_exact_models(model, dtype):
    """On an exact SDF the cull removes no surface: the tiles triangle set
    is the dense sparse=True set."""
    f = th.example(sp) if model == "example" else sp.sphere(1)
    kw = dict(samples=2**14, batch_size=8, verbose=False, dtype=dtype,
              device="cpu")
    dense = sp.generate(f, **kw)
    assert "auto_tiles" not in tengine.LAST_STATS
    tiles = sp.generate(f, sparse="tiles", **kw)
    assert len(tiles) == len(dense) > 0
    assert th.soup_hash(tiles) == th.soup_hash(dense)


def test_triangles_come_in_tile_then_cell_order():
    """The tiles soup is the reference's soup row for row (batch-then-cell
    order), not only as a set."""
    kw = dict(samples=2**13, batch_size=8, sparse="tiles", mc_variant="fast")
    want = _jax_generate(th.example(st), dtype=jnp.float64, **kw)
    got = sp.generate(th.example(sp), verbose=False, dtype=torch.float64,
                      device="cpu", **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)


def _sphere_kw():
    return dict(bounds=((-6,) * 3, (6,) * 3), step=0.12, batch_size=16)


def test_auto_route_to_tiles():
    """A unit sphere in bounds of +-6: the cull removes ~98% of the batches,
    so sparse=True routes to the tiles, says so in the statistics, keeps
    the run out of the dense counts memo, and gives the reference's mesh."""
    got = sp.generate(sp.sphere(1), device="cpu", verbose=False,
                    **_sphere_kw())
    stats = dict(tengine.LAST_STATS)
    assert stats["auto_tiles"] >= tengine.AUTO_TILES_THRESHOLD
    assert "sparse_tiles" in stats and "mc_emit" not in stats
    assert stats["batches"] == 7**3  # batch_size=16 on a 100^3 grid
    assert stats["skipped"] + stats["empty"] + stats["nonempty"] == 7**3
    assert not tengine._COUNTS_MEMO and len(tsparse._COUNTS_MEMO) == 1
    want = _jax_generate(st.sphere(1), **_sphere_kw())
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    dense = sp.generate(sp.sphere(1), device="cpu", sparse=False,
                        verbose=False, **_sphere_kw())
    assert th.soup_hash(dense) == th.soup_hash(got)


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **kw):
        calls.append(name)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_routed_run_fetches_three_times_then_two(monkeypatch):
    """Host round trips of a routed sparse=True run: the dense counts, the
    tiles counts, the mesh; a repeat finds the tiles counts memoized."""
    fetches = _count_calls(monkeypatch, tnode, "fetch")
    a = sp.generate(sp.sphere(1), device="cpu", verbose=False,
                    **_sphere_kw())
    assert len(fetches) == 3
    del fetches[:]
    b = sp.generate(sp.sphere(1), device="cpu", verbose=False,
                    **_sphere_kw())
    assert len(fetches) == 2
    np.testing.assert_array_equal(a, b)
    assert tengine.LAST_STATS["auto_tiles"] >= 0.6


def test_tiles_memos_hit_and_miss(monkeypatch):
    """Explicit tiles: two fetches cold (counts, mesh), one on a repeat; the
    host cull mask is evaluated once per expression and grid; a changed
    leaf misses both memos."""
    fetches = _count_calls(monkeypatch, tnode, "fetch")
    masks = _count_calls(monkeypatch, tengine, "_skip_mask")
    kw = dict(samples=2**13, batch_size=8, sparse="tiles", verbose=False,
              device="cpu")
    a = sp.generate(th.example(sp), **kw)
    stats = dict(tengine.LAST_STATS)
    assert (len(fetches), len(masks)) == (2, 1)
    assert len(tengine._SKIP_MEMO) == 1 and len(tsparse._COUNTS_MEMO) == 1
    b = sp.generate(th.example(sp), **kw)
    assert (len(fetches), len(masks)) == (3, 1)
    np.testing.assert_array_equal(a, b)
    for key in ("skipped", "empty", "nonempty", "triangles", "batches"):
        assert tengine.LAST_STATS[key] == stats[key]
    other = sp.sphere(0.9) & sp.box(1.5)
    sp.generate(other, **kw)
    sp.generate(sp.sphere(0.8) & sp.box(1.5), **kw)
    assert (len(fetches), len(masks)) == (7, 3)
    assert len(tengine._SKIP_MEMO) == 3 and len(tsparse._COUNTS_MEMO) == 3
    # the variant is part of the counts key, not of the mask key
    sp.generate(th.example(sp), mc_variant="fast", **kw)
    assert (len(fetches), len(masks)) == (9, 3)


@pytest.mark.parametrize("output", ["points", "mesh"])
def test_empty_tiles_results(output):
    """Bounds away from the model: every batch is culled, nothing is
    evaluated, and the result is empty with the right shapes."""
    kw = dict(bounds=((5, 5, 5), (6, 6, 6)), samples=2**12, batch_size=8,
              verbose=False, device="cpu", output=output)
    for sparse in ("tiles", True):
        out = sp.generate(sp.sphere(1), sparse=sparse, **kw)
        if output == "mesh":
            assert out[0].shape == (0, 3) and out[1].shape == (0, 3)
            assert out[1].dtype == np.int32
        else:
            assert out.shape == (0, 3) and out.dtype == np.float64
        assert tengine.LAST_STATS["triangles"] == 0
        assert tengine.LAST_STATS["skipped"] == tengine.LAST_STATS["batches"]


def test_kept_tiles_without_surface_give_an_empty_mesh():
    """Tiles the cull keeps but the surface misses: counts of zero."""
    skip = np.zeros((2, 2, 2), bool)
    X = np.linspace(3.0, 4.0, 13)
    (verts, faces), pt = tsparse.mesh_sparse_tiles(
        sp.sphere(1), X, X, X, skip, 8, torch.float32, "cpu")
    assert verts.shape == (0, 3) and faces.shape == (0, 3)
    assert pt.shape == (2, 2, 2) and not pt.any()
    assert verts[faces.reshape(-1)].shape == (0, 3)


def test_mesh_sparse_tiles_soup_and_indexed_forms():
    """The indexed mesh that mesh_sparse_tiles returns gathers to the soup
    that generate() returns for the same grid."""
    step = 2.2 / 29
    soup = sp.generate(sp.sphere(1), bounds=((-1.1,) * 3, (1.1,) * 3),
                       step=step, batch_size=8, sparse="tiles", verbose=False,
                       device="cpu")
    X = np.arange(-1.1, 1.1, step)
    skip = tengine._skip_mask(sp.sphere(1), X, X, X, 8, torch.float32)
    (verts, faces), pt = tsparse.mesh_sparse_tiles(
        sp.sphere(1), X, X, X, skip, 8, torch.float32, "cpu")
    world = verts * np.full(3, step) + np.full(3, X[0])
    assert len(soup) and faces.dtype == np.int32
    np.testing.assert_array_equal(world[faces.reshape(-1)], soup)
    assert pt.sum() == len(faces) and not pt[skip].any()


def test_tiles_profile_subphases(monkeypatch):
    monkeypatch.setattr(tsparse, "PROFILE", True)
    sp.generate(th.example(sp), samples=2**13, batch_size=8, sparse="tiles",
                verbose=False, device="cpu")
    for key in ("tiles_device", "tiles_d2h", "tiles_d2h_bytes",
                "tiles_decode", "skip_mask", "sparse_tiles"):
        assert key in tengine.LAST_STATS, key
    assert tengine.LAST_STATS["tiles_d2h_bytes"] > 0


def test_tiles_debug_boxes_match_jax():
    kw = dict(samples=2**12, debug=True, batch_size=4, sparse="tiles",
              mc_variant="fast")
    want = _jax_generate(th.example(st), dtype=jnp.float64, **kw)
    got = sp.generate(th.example(sp), verbose=False, dtype=torch.float64,
                      device="cpu", **kw)
    assert len(got) == len(want)
    assert th.soup_hash(got) == th.soup_hash(want)


def test_tiles_output_mesh_and_save(tmp_path):
    kw = dict(samples=2**13, batch_size=8, sparse="tiles", verbose=False,
              device="cpu")
    pts = sp.generate(th.example(sp), **kw)
    verts, faces = sp.generate(th.example(sp), output="mesh", **kw)
    assert faces.dtype == np.int32 and verts.dtype == np.float64
    np.testing.assert_array_equal(verts[faces.reshape(-1)], pts)
    vw, fw = _jax_generate(th.example(st), output="mesh", samples=2**13,
                           batch_size=8, sparse="tiles")
    np.testing.assert_array_equal(faces, fw)
    np.testing.assert_allclose(verts, vw, rtol=0, atol=2e-6)
    path = str(tmp_path / "tiles.stl")
    saved = th.example(sp).save(path, **kw)
    np.testing.assert_array_equal(saved, pts)
    _, tris = sp.stl.read_binary_stl(path)
    assert len(tris) == len(pts) // 3


def test_tiles_checkpoint_resumes(tmp_path, monkeypatch):
    path = str(tmp_path / "tiles.ckpt.npz")
    kw = dict(samples=2**13, batch_size=8, sparse="tiles", verbose=False,
              device="cpu", checkpoint=path)
    first = sp.generate(th.example(sp), **kw)
    fetches = _count_calls(monkeypatch, tnode, "fetch")
    again = sp.generate(th.example(sp), **kw)
    assert not fetches  # loaded, not recomputed
    np.testing.assert_array_equal(first, again)
    kw["sparse"] = True  # another cull mode is another file key
    sp.generate(th.example(sp), **kw)
    assert fetches


def test_gather_expression_meshes_through_tiles():
    """A gather-bearing expression under sparse='tiles' takes the per-tile
    route (fields recorded ahead) and gives the mesh of the dense path."""
    f = th.gather_models(sp)["rotated"]
    kw = dict(bounds=((-1.3,) * 3, (1.3,) * 3), samples=2**13, batch_size=8,
              verbose=False, device="cpu")
    tiles = sp.generate(f, sparse="tiles", **kw)
    (key,) = tsparse._COUNTS_MEMO
    assert key[1] == "pertile"
    dense = sp.generate(f, sparse=False, **kw)
    assert len(tiles) and len(tiles) == len(dense)
    assert th.soup_hash(tiles) == th.soup_hash(dense)


def test_gather_expression_routes_to_tiles_at_the_defaults():
    """sparse=True on a gather-bearing expression routes by the cull alone,
    as the JAX package does (no gather rule, no ``gather_tiles`` key): at
    these bounds the cull removes 9 of 27 batches, under
    AUTO_TILES_THRESHOLD, so the run stays dense and kernel B1's pre-pass
    records the fields; with the threshold under the cull the same call
    goes to the tiles and gives the sparse='tiles' soup bit for bit; both
    routes give one canonical soup."""
    f = th.gather_models(sp)["circular"]
    kw = dict(bounds=((-1.3,) * 3, (1.3,) * 3), samples=2**13, batch_size=8,
              verbose=False, device="cpu")
    dense = sp.generate(f, **kw)
    stats = dict(tengine.LAST_STATS)
    assert stats["skipped"] == 9 and stats["batches"] == 27
    assert "record_fields" in stats and "eval_classify" in stats
    assert "auto_tiles" not in stats and "sparse_tiles" not in stats
    assert "gather_tiles" not in stats
    threshold = tengine.AUTO_TILES_THRESHOLD
    tengine.AUTO_TILES_THRESHOLD = 0.3
    tengine._COUNTS_MEMO.clear()  # the dense run's counts would stop the route
    try:
        got = sp.generate(f, **kw)
        stats = dict(tengine.LAST_STATS)
    finally:
        tengine.AUTO_TILES_THRESHOLD = threshold
    assert stats["auto_tiles"] == round(9 / 27, 4) and "sparse_tiles" in stats
    want = sp.generate(f, sparse="tiles", **kw)
    assert "gather_tiles" not in tengine.LAST_STATS
    assert len(got) and np.array_equal(got, want)
    assert th.soup_hash(dense) == th.soup_hash(got)
