"""Sharded sparse tiles: the active-tile list dealt over the ranks of a
``DeviceMesh`` (counterpart of ``sdf_tpu.parallel.sparse``).

Z slabs (``parallel.grid``) balance volume; for sparse models the surface
tiles cluster, so the list of active tiles is dealt round-robin: every rank
gets the same number of surface tiles wherever the surface sits.  Tiles
carry global indices, so a rank's marching cubes needs no offset and no
halo exchange.  Each rank runs the single-device tile route on its rows:
kernel B6 (gather-free) or B7 (gather-bearing) with ``live=`` its count of
live rows, B2 under lewiner, B3, then B4 and B5 in the emit.

Collectives: an all-gather of the per-tile counts, so every rank holds the
whole statistics grid, and one all-reduce (max) of ``(triangles, cells,
edges)`` for the emit capacities.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import eval_classify, hybrid, mc, mc33, node
from ..core import sparse as core_sparse
from ..core.node import resolve_device, upload
from .multihost import all_gather_host, all_reduce_host, coords
from .shards import assemble_indexed


def _deal_tiles(active, ranks):
    """Deal the ``(nt, 3)`` active tiles round-robin over ``ranks``: returns
    ``(tiles (ranks * tpd, 3) int32, live (ranks * tpd,) bool)``, rank-major
    with ``tpd`` rows a rank (a power of two or 1.5 times one, at least
    ``ceil(nt / ranks)``).  Rank ``d`` holds tiles ``d, d + ranks, ...``;
    its padded rows repeat tile (0, 0, 0) at the tail of its rows, the
    layout kernels B6/B7 take with ``live=``."""
    nt = len(active)
    tpd = mc.round_capacity(-(-nt // ranks))
    ntc = tpd * ranks
    tiles = np.zeros((ntc, 3), dtype=np.int32)
    tiles[:nt] = active
    live = np.zeros((ntc,), dtype=bool)
    live[:nt] = True
    order = np.arange(ntc).reshape(tpd, ranks).T.reshape(-1)
    return tiles[order], live[order]


def mesh_sparse_tiles_sharded(sdf, X, Y, Z, skip, tile, mesh, dtype,
                              device=None, return_indexed=False,
                              variant="default"):
    """Tiled sparse pipeline, the tile list dealt over ``mesh``'s ranks.

    The inputs and outputs of ``core.sparse.mesh_sparse_tiles``, per rank:
    this rank's share of the mesh (its tiles, in (tile, cell) order; a host
    float64 soup, or the indexed ``(everts, faces)`` with
    ``return_indexed``) and the GLOBAL per-tile counts, the same on every
    rank.  ``parallel.gather_triangles`` assembles the shares rank-major.
    ``mesh`` None runs the whole list on one device."""
    rank, ndev, group = coords(mesh)
    device = resolve_device(device)
    cshape = (len(X) - 1, len(Y) - 1, len(Z) - 1)
    pt = np.zeros(skip.shape, dtype=np.int64)

    def empty(pt):
        v = np.zeros((0, 3), dtype=np.float64)
        return ((v, np.zeros((0, 3), np.int32)) if return_indexed else v), pt

    active = np.argwhere(~skip)  # (nt, 3) x-major, the same on every rank
    if len(active) == 0:
        return empty(pt)
    tiles, live = _deal_tiles(active, ndev)
    tpd = len(tiles) // ndev
    mine = slice(rank * tpd, (rank + 1) * tpd)
    nlive = int(live[mine].sum())
    (tiles_d,) = upload([tiles[mine]], torch.int32, device)
    (live_d,) = upload([live[mine]], torch.bool, device)

    if hybrid.count_gathers(sdf):
        pad = lambda A: np.concatenate([A, np.full(tile, A[-1])])
        vols, case = eval_classify.eval_tiles_and_classify(
            sdf, pad(X), pad(Y), pad(Z), tiles_d, tile, dtype, live=nlive)
    else:
        vols, case = eval_classify.eval_tiles_and_classify_batched(
            sdf, X, Y, Z, tiles_d, tile, dtype, live=nlive)
    if variant != "default":
        case = mc33.classify_ext(vols, base_case=case)
    total, per_tile, ncell, case, nedge, emask = core_sparse._count_tiles(
        vols, tiles_d, live_d, cshape, tile, case, variant)
    total, ncell, nedge, per_tile = node.fetch(
        [total.to(torch.int64), ncell, nedge, per_tile.to(torch.int64)])
    total, nedge = int(total), int(nedge)
    counts = all_gather_host(per_tile, group).reshape(-1)  # rank-major
    pt[tuple(tiles[live].T)] = counts[live]
    gmax = all_reduce_host(np.asarray([total, ncell, nedge], np.int64), "max",
                           group)
    if gmax[0] == 0:
        return empty(pt)

    capacity, cell_capacity, edge_capacity = (
        mc.round_capacity(int(n)) for n in gmax)
    everts, faces, _ = core_sparse._emit_tiles_indexed(
        vols, tiles_d, live_d, case, emask, cshape, edge_capacity, capacity,
        cell_capacity, tile, variant=variant)
    return assemble_indexed(everts, faces, total, nedge, return_indexed), pt
