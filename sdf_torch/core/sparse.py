"""Sparse tiled evaluation: evaluate only the tiles the coarse cull kept
(counterpart of ``sdf_tpu.core.sparse``, single device).

The dense engine evaluates every grid sample and uses the probe-based skip
mask only to mask marching-cubes cells.  Here the skip mask selects the
*active* ``tile^3``-cell tiles, their volumes (one halo sample each way,
the reference's batch overlap) are evaluated by kernel B6 or B7
(``core.eval_classify``), and marching cubes runs tile-locally: work
scales with surface area instead of grid volume.

Triangle order is (tile, cell) ascending with tiles in x-major order, the
reference's batch-then-cell order.

Enable with ``generate(..., sparse="tiles")``; ``sparse=True`` routes here
when the cull removes most of the batches.

Which kernel evaluates is a rule, not a measurement: an expression the
generated body holds whole runs ``eval_tiles_and_classify_batched``
(B6), one with gather-marked subtrees runs ``eval_tiles_and_classify``
(B7, on axes padded by one tile); on the CPU each wrapper runs its plain
version.  The JAX module's ``_eval_tiles_auto``, ``_race`` and
``_BATCHED_CZ`` (a ladder of block sizes that fit on-chip memory and a
timed race against the compiler's own evaluation) have no counterpart.
``generate()`` uses the indexed emit; the soup form ``_emit_tiles`` shares
``mc.interpolate_slots`` with the differentiable path.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..utils import checkpoint as ckpt
from . import compact, eval_classify, hybrid, mc, mc33, node, spans
from .eval_classify import _eval_tiles  # noqa: F401  (B6/B7's plain version)
from .mc import round_capacity
from .node import upload


def _tile_cases(vols, tile, variant="default"):
    """Case codes for every tile-local cell of ``(ntc, TS, TS, TS)`` tile
    volumes: ``(ntc, tile, tile, tile)`` int32, 8-bit corner-sign codes or,
    under lewiner, the extended codes (kernel B2 on the batch)."""
    if vols.shape[-1] != tile + 1:
        raise ValueError("tile volumes must have tile + 1 samples per axis")
    if variant != "default":
        return mc33.classify_ext(vols)
    return mc._cell_cases(vols)


def _cell_valid(tiles, live, cshape, tile):
    """(ntc, tile, tile, tile) mask: cell inside the global grid + live
    tile."""
    ncx, ncy, ncz = cshape
    ar = torch.arange(tile, device=tiles.device)
    t = tiles.to(torch.int64)
    gx = t[:, 0, None] * tile + ar[None, :]  # (ntc, tile)
    gy = t[:, 1, None] * tile + ar[None, :]
    gz = t[:, 2, None] * tile + ar[None, :]
    m = (
        (gx < ncx)[:, :, None, None]
        & (gy < ncy)[:, None, :, None]
        & (gz < ncz)[:, None, None, :]
    )
    return m & live[:, None, None, None]


def _tile_edge_mask(vols, active, tile):
    """(ntc, 3 * tile * TS^2) bool: per-tile local active-edge mask.

    Within each tile: sign-crossing AND adjacent to an active cell (the rule
    of ``mc._edge_mask``, tile-locally).  An edge on a face shared by two
    active tiles appears in both, so those vertices stay duplicated; within
    a tile they dedup.  Layout per tile: [x-edge block | y | z], each block
    row-major over its (tile, TS, TS)/(TS, tile, TS)/(TS, TS, tile) edge
    grid."""
    sign = vols < 0

    def adj(a, axes):
        shape = list(a.shape)
        for ax in axes:
            shape[ax] += 2
        b = torch.zeros(shape, dtype=torch.bool, device=a.device)
        inner = [slice(None)] * 4
        for ax in axes:
            inner[ax] = slice(1, shape[ax] - 1)
        b[tuple(inner)] = a
        for ax in axes:
            lo = [slice(None)] * 4
            hi = [slice(None)] * 4
            lo[ax] = slice(0, b.shape[ax] - 1)
            hi[ax] = slice(1, None)
            b = b[tuple(lo)] | b[tuple(hi)]
        return b

    ntc = vols.shape[0]
    ex = (sign[:, :-1] != sign[:, 1:]) & adj(active, (2, 3))
    ey = (sign[:, :, :-1] != sign[:, :, 1:]) & adj(active, (1, 3))
    ez = (sign[:, :, :, :-1] != sign[:, :, :, 1:]) & adj(active, (1, 2))
    return torch.cat(
        [ex.reshape(ntc, -1), ey.reshape(ntc, -1), ez.reshape(ntc, -1)], dim=1
    )


def _count_tiles(vols, tiles, live, cshape, tile, case=None,
                 variant="default"):
    """Every count the host needs before emit.  Returns ``(total_tris,
    per_tile (ntc,), n_cells, case, n_edges, emask)``: the counts are device
    tensors to fetch in ONE transfer; ``case`` and ``emask`` stay for
    ``_emit_tiles_indexed``."""
    if case is None:
        case = _tile_cases(vols, tile, variant)
    valid = _cell_valid(tiles, live, cshape, tile)
    ntri = mc.ntri_of(case, variant) * valid.to(torch.int32)
    per_tile = ntri.sum(dim=(1, 2, 3))
    ncell = (ntri > 0).sum()
    emask = _tile_edge_mask(vols, ntri > 0, tile)
    return ntri.sum(), per_tile, ncell, case, emask.sum(), emask


_GID_DEV = {}  # (tile, variant, device) -> the tile-local _gid_pack table


def _emit_tiles(vols, tiles, live, case, cshape, capacity, cell_capacity,
                tile, variant="default"):
    """Tile-local marching cubes as a soup: ``(verts (9, capacity),
    n_tris)`` in global fractional index coordinates, the layout of
    ``mc.emit`` (see sdf_tpu.core.sparse._emit_tiles).  A cell's base is
    ``tiles[t] * tile + local``; the interpolation is
    ``mc.interpolate_slots``."""
    TS = tile + 1
    valid = _cell_valid(tiles, live, cshape, tile)
    ntri = mc.ntri_of(case, variant) * valid.to(torch.int32)
    cell_idx, n_cells = compact.indices_of((ntri > 0).reshape(-1),
                                           cell_capacity)
    cell_idx = cell_idx.to(torch.int64)
    cell_live = torch.arange(cell_capacity, device=case.device) < n_cells
    t_of = cell_idx // (tile * tile * tile)
    local = cell_idx % (tile * tile * tile)
    li, rem = local // (tile * tile), local % (tile * tile)
    lj, lk = rem // tile, rem % tile
    cell_case = case.reshape(-1)[cell_idx]
    cell_ntri = torch.where(cell_live, ntri.reshape(-1)[cell_idx], 0)
    vflat = vols.reshape(-1)
    corner = [
        mc._take(vflat, 0,
                 ((t_of * TS + li + ox) * TS + (lj + oy)) * TS + (lk + oz))
        for ox, oy, oz in mc.CORNER_OFFSETS.tolist()
    ]
    t = tiles.to(torch.int64)[t_of]
    base = tuple((t[:, a] * tile + loc).to(vols.dtype)
                 for a, loc in enumerate((li, lj, lk)))
    return mc.interpolate_slots(corner, base, cell_case, cell_ntri, capacity,
                                cell_capacity, variant)


def _tile_gid_table(tile, variant, device):
    key = (tile, variant, str(device))
    if key not in _GID_DEV:
        TS = tile + 1
        Sblk = tile * TS * TS
        tab = mc._gid_pack(
            [(TS * TS, TS), (tile * TS, TS), (TS * tile, tile)],
            [0, Sblk, 2 * Sblk], variant,
        )
        if len(_GID_DEV) > 16:
            _GID_DEV.clear()
        _GID_DEV[key] = upload([tab], torch.int64, device)[0]
    return _GID_DEV[key]


def _word_pack_fits(tile, cbits):
    """Whether a triangle's (tile-local cell, case code) fits one int32
    word: ``tile^3 << case_bits`` distinct values.  With 8-bit codes that
    holds to tile 203; with lewiner's 13-bit codes it ends at tile 64.
    (``generate(batch_size=)`` is the public knob behind ``tile``.)"""
    return tile**3 * (1 << cbits) <= 2**31


def _emit_tiles_indexed(vols, tiles, live, case, emask, cshape,
                        edge_capacity, capacity, cell_capacity, tile,
                        packed=False, variant="default"):
    """Tile-local indexed marching cubes: unique per-edge vertices ``(3,
    edge_capacity)`` in global fractional index coordinates, int32 faces
    ``(3, capacity)`` and the triangle count.

    The tile analog of ``mc.emit_indexed``: edge ids live in per-tile local
    edge grids (``tid * Stile + axis block + row-major local``), so
    vertices dedup within a tile and stay duplicated across tile
    boundaries.  ``everts.T[faces.T.reshape(-1)]`` is the triangle soup in
    (tile, cell) order.  ``packed`` selects the wire format as in
    ``mc.gather_emit_indexed`` (float32 only when not False)."""
    if packed is not False and vols.dtype != torch.float32:
        raise ValueError("packed emit needs float32 tile volumes")
    eidx, t, (tid, a, x, y, z), faces, n_tris = _emit_tiles_core(
        vols, tiles, live, case, emask, cshape, edge_capacity, capacity,
        cell_capacity, tile, variant)
    if packed is not False:
        # Wire format: (edge id, t bits); the host rebuilds positions with
        # the same float32 ops (unpack_tiles_indexed).
        everts = torch.stack([eidx.to(torch.int32), t.view(torch.int32)],
                             dim=0)
        faces = mc.pack_faces_words(faces, packed is True)
    else:
        everts = mc.edge_verts(a, _tile_starts(tiles, tile, tid, (x, y, z)),
                               t)
    return everts, faces, n_tris


def _tile_starts(tiles, tile, tid, local):
    """The global integer starts (int64) of edges at tile-local starts
    ``local`` in the tiles ``tid`` of the tile list ``tiles``."""
    trow = tiles.to(torch.int64)[tid]  # (edge_capacity, 3)
    return [trow[:, k] * tile + c for k, c in enumerate(local)]


def _emit_tiles_core(vols, tiles, live, case, emask, cshape, edge_capacity,
                     capacity, cell_capacity, tile, variant="default"):
    """The body of ``_emit_tiles_indexed``: ``(eidx int32, t, (tid, axis,
    x, y, z), faces (3, capacity) ranks, n_tris)``, each per-edge tensor
    ``(edge_capacity,)``, ``x, y, z`` the edge's tile-local start.

    Edge ids are int32 in the compaction kernels and on the wire, so
    ``ntc * Stile`` must stay below 2^31 (grids to about 2^28 samples at
    tile 32); a larger tile list raises."""
    TS = tile + 1
    Sblk = tile * TS * TS  # one axis' edge block per tile
    Stile = 3 * Sblk
    ntc = vols.shape[0]
    if ntc * Stile >= 2**31:
        raise ValueError(
            "tiled emit: %d tiles of %d edge slots exceed int32 edge ids"
            % (ntc, Stile))
    tab = mc.get_tables(variant)
    cbits, max_tris = tab.case_bits, tab.max_tris
    valid = _cell_valid(tiles, live, cshape, tile)
    ntri = mc.ntri_of(case, variant) * valid.to(torch.int32)

    active = (ntri > 0).reshape(-1)
    cell_idx, n_cells = compact.indices_of(active, cell_capacity)
    cell_live = torch.arange(cell_capacity, device=vols.device) < n_cells
    cell_idx = cell_idx.to(torch.int64)
    t3 = tile * tile * tile
    t_of = cell_idx // t3
    local = cell_idx % t3
    li, rem = local // (tile * tile), local % (tile * tile)
    lj, lk = rem // tile, rem % tile
    cell_case = case.reshape(-1)[cell_idx].to(torch.int64)
    cell_ntri = torch.where(cell_live, ntri.reshape(-1)[cell_idx], 0)

    # --- one vertex per tile-local active edge -------------------------------
    eidx, ranktab, _ = compact.indices_and_ranktable_of(
        emask.reshape(-1), edge_capacity)
    e = eidx.to(torch.int64)
    tid = e // Stile
    block = e % Stile
    a = block // Sblk
    le = block % Sblk  # the three axis blocks are equal-sized

    def dec(l, d1, d2):  # row-major (d0, d1, d2) decode
        return l // (d1 * d2), (l // d2) % d1, l % d2

    e0 = dec(le, TS, TS)  # x-edges: (tile, TS, TS)
    e1 = dec(le, tile, TS)  # y-edges: (TS, tile, TS)
    e2 = dec(le, TS, tile)  # z-edges: (TS, TS, tile)

    def pick(i):
        return torch.where(a == 0, e0[i], torch.where(a == 1, e1[i], e2[i]))

    x, y, z = pick(0), pick(1), pick(2)
    vflat = vols.reshape(-1)
    vlin = ((tid * TS + x) * TS + y) * TS + z
    stride = torch.where(a == 0, TS * TS, torch.where(a == 1, TS, 1))
    va = vflat[vlin]
    vb = vflat[vlin + stride]
    denom = va - vb
    # The zero-crossing formula of mc._emit_indexed_core, term for term.
    t = torch.clamp(
        torch.clamp(va / torch.where(denom == 0, 1.0, denom), min=0.0), max=1.0
    )

    # --- tri-major face resolution (see mc._resolve_faces) -------------------
    if _word_pack_fits(tile, cbits):
        # One word per cell (local index, case) rides the ragged expansion
        # to its triangles; the tile id is gathered by cell.
        w = ((li * tile + lj) * tile + lk) * (1 << cbits) + cell_case
        ctri, slot, n_tris, wt = compact.ragged_expand(cell_ntri, capacity,
                                                       fill=w)
        tt = t_of[ctri]
        case_t = wt & ((1 << cbits) - 1)
        loc = wt >> cbits
        cx = loc // (tile * tile)
        cy = (loc // tile) % tile
        cz = loc % tile
    else:
        ctri, slot, n_tris = compact.ragged_expand(cell_ntri, capacity)
        cellpack = torch.cat([t_of, li, lj, lk, cell_case])
        cd = cellpack[
            torch.cat([ctri + i * cell_capacity for i in range(5)])
        ]
        tt = cd[:capacity]
        cx = cd[capacity: 2 * capacity]
        cy = cd[2 * capacity: 3 * capacity]
        cz = cd[3 * capacity: 4 * capacity]
        case_t = cd[4 * capacity:]

    row = _tile_gid_table(tile, variant, vols.device)[case_t * max_tris + slot]
    gids = [
        tt * Stile + cx * row[:, 3 * v] + cy * row[:, 3 * v + 1] + cz
        + row[:, 3 * v + 2]
        for v in range(3)
    ]
    faces = compact.rank_lookup(ranktab, torch.cat(gids)).reshape(3, capacity)
    return eidx, t, (tid, a, x, y, z), faces, n_tris


def unpack_tiles_indexed(epack, fpack, tiles_np, tile, dtype=np.float32):
    """Host decode of the packed tiles emit (numpy uint32, already sliced
    to live counts): bit-identical to the plain ``_emit_tiles_indexed``
    outputs (the same IEEE float32 operations)."""
    TS = tile + 1
    Sblk = tile * TS * TS
    Stile = 3 * Sblk
    eidx = epack[0].astype(np.int64)
    t = epack[1].view(np.float32) if epack.dtype == np.uint32 else epack[1]
    tid = eidx // Stile
    block = eidx % Stile
    a = block // Sblk
    le = block % Sblk
    ft = np.dtype(dtype)
    vh32 = np.empty((len(eidx), 3), dtype=ft)
    base = tiles_np[tid].astype(np.int64) * tile  # (ne, 3)
    dims = ((tile, TS, TS), (TS, tile, TS), (TS, TS, tile))
    for av in range(3):
        m = a == av
        _, d1, d2 = dims[av]
        l = le[m]
        z = l % d2
        rem = l // d2
        exyz = (rem // d1, rem % d1, z)
        for c in range(3):
            comp = (base[m, c] + exyz[c]).astype(ft)
            if c == av:
                comp = comp + t[m].astype(ft)
            vh32[m, c] = comp
    return vh32.astype(np.float64), mc.unpack_faces(fpack)


# Memoized (n_tris, n_cells, n_edges) per engine-provided key + cull mask +
# eval route: deterministic, so a repeat run skips the pre-emit fetch and
# takes the per-tile statistics with the mesh (as engine._COUNTS_MEMO).
_COUNTS_MEMO = {}

# When True, mesh_sparse_tiles splits its wall time into device / d2h /
# decode sub-phases in the ``generate()`` call's stats, ``tiles_device``,
# ``tiles_d2h`` (with ``tiles_d2h_bytes``) and ``tiles_decode`` (one extra
# fenced read per run, to separate device completion from transfer; off by
# default so the warm path keeps its one wait).  The spans ``tiles_d2h``
# and ``tiles_decode`` open their profiler ranges either way.
PROFILE = False


def mesh_sparse_tiles(sdf, X, Y, Z, skip, tile, dtype, device, memo_key=None,
                      variant="default", stats=None):
    """Tiled sparse pipeline: eval + marching cubes on active tiles only.

    ``sdf`` is the uncast expression, X/Y/Z host float64 axis coordinates,
    ``skip`` the host probe-cull mask (True = culled) at ``tile`` cells per
    tile per axis.  Returns ``((everts (V, 3) float64 in fractional index
    coordinates, faces (T, 3) int32), per_tile_counts (tx, ty, tz))``: the
    indexed mesh the device emitted; ``everts[faces.reshape(-1)]`` is the
    triangle soup.  ``memo_key``
    (an expression + grid fingerprint from the engine) enables count
    memoization across repeat runs.

    Host waits: one for the counts (none on a memo hit), one for the mesh.
    The active-tile list is made on the host from ``skip``.  Subtrees the
    kernels' body cannot hold become fields (``hybrid.route_fields``)."""
    dev0 = spans.clock()  # "tiles_device" starts here (PROFILE)
    device = torch.device(device)
    with spans.span("route_fields"):
        sdf, _ = hybrid.route_fields(sdf, stats, dtype)
    nx, ny, nz = len(X), len(Y), len(Z)
    cshape = (nx - 1, ny - 1, nz - 1)

    def empty(pt):
        return (np.zeros((0, 3), np.float64), np.zeros((0, 3), np.int32)), pt

    active = np.argwhere(~skip)  # (nt, 3) host, x-major order
    nt = len(active)
    pt = np.zeros(skip.shape, dtype=np.int64)
    if nt == 0:
        return empty(pt)
    ntc = round_capacity(nt)
    # Padding rows repeat tile (0, 0, 0): rows nt..ntc-1 are all equal, so
    # the eval kernels take ``live=nt``, evaluate row nt once and copy it.
    tiles = np.zeros((ntc, 3), dtype=np.int32)
    tiles[:nt] = active
    live = np.zeros((ntc,), dtype=bool)
    live[:nt] = True
    (tiles_d,) = upload([tiles], torch.int32, device)
    (live_d,) = upload([live], torch.bool, device)

    if hybrid.count_gathers(sdf):
        # Gather-bearing expressions: the per-tile kernel with the recorded
        # fields.  Edge tiles read one tile past the end: pad each axis
        # with its last coordinate (the samples index clamping gives; the
        # repeated-sample cells are masked downstream).
        pad = lambda A: np.concatenate([A, np.full(tile, A[-1])])
        vols, case = eval_classify.eval_tiles_and_classify(
            sdf, pad(X), pad(Y), pad(Z), tiles_d, tile, dtype, live=nt)
        mode = "pertile"
    else:
        vols, case = eval_classify.eval_tiles_and_classify_batched(
            sdf, X, Y, Z, tiles_d, tile, dtype, live=nt)
        mode = "batched"
    if variant != "default":
        # extend the kernels' 8-bit codes with the variant bits
        case = mc33.classify_ext(vols, base_case=case)
    total, per_tile, ncell, case, nedge, emask = _count_tiles(
        vols, tiles_d, live_d, cshape, tile, case, variant
    )
    # Counts are deterministic in (expression, grid, dtype, cull mask, eval
    # route): on a memoized repeat run, skip the pre-emit fetch and take the
    # per-tile statistics WITH the mesh in one transfer.
    ckey = cached = None
    if memo_key is not None:
        with spans.span("fingerprint"):
            mask = hashlib.sha256(np.ascontiguousarray(skip).tobytes())
            ckey = (memo_key, mode, tile, variant, mask.hexdigest())
        cached = _COUNTS_MEMO.get(ckey)
    per_tile_h = None
    if cached is not None:
        n, ncl, ne = cached
    else:
        # One transfer for all three capacity counts + statistics.
        with spans.span("counts"):
            n, ncl, ne, per_tile_h = node.fetch([total, ncell, nedge,
                                                 per_tile])
        n, ncl, ne = int(n), int(ncl), int(ne)
        ckpt.memo_put(_COUNTS_MEMO, ckey, (n, ncl, ne))

    if n == 0:
        if per_tile_h is None:
            (per_tile_h,) = node.fetch([per_tile])
        pt[tuple(active.T)] = per_tile_h[:nt]
        return empty(pt)

    capacity = round_capacity(n)
    cell_capacity = round_capacity(ncl)
    edge_capacity = round_capacity(ne)
    eidx, t, (tid, a, x, y, z), faces, _ = _emit_tiles_core(
        vols, tiles_d, live_d, case, emask, cshape, edge_capacity, capacity,
        cell_capacity, tile, variant)
    mesh, decode = mc.readback(
        eidx, t, faces, ne, n,
        plain=lambda: mc.edge_verts(a, _tile_starts(tiles_d, tile, tid,
                                                    (x, y, z)), t),
        unpack=lambda e, f: unpack_tiles_indexed(e, f, tiles, tile),
        tiles=tiles_d, tile=tile)
    # The emitted count equals ``total`` (fetched or memoized), so the
    # slices need no further wait.  "tiles_device" (PROFILE) is everything
    # from entry (dispatch, eval, the counts wait on a cold run, emit) to
    # the fence before the transfer.
    got = node.fetch_mesh(mesh + ([per_tile] if per_tile_h is None else []),
                          len(mesh), device, dev0, prefix="tiles_",
                          profile=PROFILE)
    if per_tile_h is None:
        per_tile_h = got[len(mesh)]
    with spans.span("tiles_decode", key=PROFILE):
        pt[tuple(active.T)] = per_tile_h[:nt]
        mesh_h = decode(got[:len(mesh)])
    return mesh_h, pt
