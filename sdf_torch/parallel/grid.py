"""Sharded grid sampling + meshing over the ranks of a ``DeviceMesh``
(counterpart of ``sdf_tpu.parallel.grid``).

The sample grid is cut into z slabs, one a rank.  Rank ``r`` samples the
global z indices ``[r*c, r*c + c]`` with ``c = ceil(ncz / ranks)``: the
extra sample is the halo plane that marching cubes needs, recomputed and
not exchanged (the reference's +1-sample batch overlap).  Indices past the
grid are clamped and their cells masked.  Each rank evaluates and
classifies its slab with its own kernels (B1, then B2 under lewiner),
counts (B3), compacts (B4) and emits (B5 inside ``mc.emit_indexed``), with
the slab offset added to the integer z before the float interpolation, so
its vertices are bit-identical to a single-device run over the whole grid.

Collectives: one all-reduce (sum) of the per-tile triangle counts, binned
into global z tiles (the JAX package's ``psum``), and one all-reduce (max)
of ``(triangles, cells, edges)`` (its three ``pmax``), so every rank sizes
its buffers alike.  Host reads: one for the counts, one for the mesh, as on
a single device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..core import eval_classify, hybrid, mc, mc33, node
from ..core.node import resolve_device, upload
from .multihost import AXIS, all_reduce_host, coords
from .shards import assemble_indexed

_WORLD_MESHES = {}  # (default process group, device type) -> DeviceMesh


def make_mesh(device_type=None, axis_name=AXIS):
    """A 1-D ``DeviceMesh`` over every rank of the process group, its one
    dimension named ``axis_name``.  ``device_type`` None means ``"cuda"``,
    as everywhere in the port; pass ``"cpu"`` for ranks on the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed: call "
                           "sdf_torch.parallel.initialize() first")
    return init_device_mesh(device_type or "cuda", (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def world_mesh(device):
    """The mesh that ``generate()`` shards over when it is given none:
    every rank when ``torch.distributed`` runs more than one (made once a
    process group and device type; ``device`` None means the card), else
    None (one device)."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return None
    key = (dist.group.WORLD, resolve_device(device).type)
    if key not in _WORLD_MESHES:
        _WORLD_MESHES[key] = make_mesh(key[1])
    return _WORLD_MESHES[key]


def _slab_cell_mask(keep, rank, c, ncz, tile, cshape, device):
    """This rank's ``(ncx, ncy, c)`` cell mask: the kept tiles (``keep``,
    the host's (tx, ty, tz) mask) expanded to cells, the slab's z cells in
    global tiles, padded cells (past the grid) off."""
    zcells = rank * c + np.arange(c)
    ztile = np.clip(zcells // tile, 0, keep.shape[2] - 1)
    k, zok = upload([keep[:, :, ztile], zcells < ncz], torch.bool, device)
    tx, ty = keep.shape[:2]
    m = k[:, None, :, None, :].expand(tx, tile, ty, tile, c)
    m = m.reshape(tx * tile, ty * tile, c)[: cshape[0], : cshape[1]]
    return m & zok


def _global_tiles(ntri, rank, c, tile, n_z_tiles):
    """Per-tile triangle counts of the slab binned into GLOBAL z tiles
    (slab boundaries need not fall on tile boundaries): ``(tx, ty,
    n_z_tiles)`` int64."""
    ncx, ncy, _ = ntri.shape
    px, py = (-ncx) % tile, (-ncy) % tile
    padded = torch.nn.functional.pad(ntri.to(torch.int64), (0, 0, 0, py, 0, px))
    tx, ty = (ncx + px) // tile, (ncy + py) // tile
    xy = padded.reshape(tx, tile, ty, tile, c).sum(dim=(1, 3))
    # Padded cells count 0; clamping their tile keeps the index in range.
    ztile = torch.clamp((rank * c + torch.arange(c, device=ntri.device))
                        // tile, max=n_z_tiles - 1)
    out = torch.zeros((tx, ty, n_z_tiles), dtype=torch.int64,
                      device=ntri.device)
    return out.index_add_(2, ztile, xy)


def mesh_and_march(sdf, X, Y, Z, skip, tile, mesh, dtype, device=None,
                   return_indexed=False, variant="default"):
    """Sharded volume eval + marching cubes: this rank's z slab.

    sdf: the uncast expression.  X/Y/Z: host float64 axis coordinates.
    skip: (tx, ty, tz) bool per-tile cull mask (True = cull), the same on
    every rank.  Returns ``(verts, per_tile)``: this rank's share of the
    mesh, a host float64 ``(3T, 3)`` soup in fractional index coordinates
    (or with ``return_indexed`` the indexed ``(everts (V, 3) float64,
    faces (T, 3) int32)``, whose vertices on a slab's boundary plane appear
    in both slabs), and the GLOBAL per-tile triangle counts, the same on
    every rank.  ``parallel.gather_triangles`` assembles the shares
    rank-major.  ``mesh`` None runs the whole grid as one slab."""
    rank, ndev, group = coords(mesh)
    device = resolve_device(device)
    sdf, _ = hybrid.route_fields(sdf, dtype=dtype)
    nx, ny, nz = len(X), len(Y), len(Z)
    ncz = nz - 1
    c = -(-ncz // ndev)  # cells a slab
    cshape = (nx - 1, ny - 1, c)
    Zs = np.asarray(Z)[np.minimum(rank * c + np.arange(c + 1), nz - 1)]

    # Phase count: B1 (its fields recorded over the slab for a gather-
    # bearing expression), B2 under lewiner, B3 under the slab's mask.
    fields = eval_classify.record_fields(sdf, X, Y, Zs, dtype, device)
    vol, case = eval_classify.eval_and_classify(sdf, X, Y, Zs, dtype, device,
                                                fields)
    del fields
    if variant != "default":
        case = mc33.classify_ext(vol, base_case=case)
    keep = _slab_cell_mask(~skip, rank, c, ncz, tile, cshape, device)
    ntri = mc.ntri_of(case, variant) * keep.to(torch.int32)
    active = ntri > 0
    per_tile = _global_tiles(ntri, rank, c, tile, skip.shape[2])
    emask = mc._edge_mask(vol, active)
    total, ncell, nedge, per_tile = node.fetch(
        [ntri.sum(dtype=torch.int64), active.sum(), emask.sum(), per_tile])
    total, nedge = int(total), int(nedge)
    per_tile = all_reduce_host(per_tile, "sum", group)
    # Every rank sizes its buffers from the same maxima, and leaves early
    # on the same reduced total: the collectives stay in step.
    gmax = all_reduce_host(np.asarray([total, ncell, nedge], np.int64), "max",
                           group)
    if gmax[0] == 0:
        v = np.zeros((0, 3), np.float64)
        return ((v, np.zeros((0, 3), np.int32)) if return_indexed else v,
                per_tile)

    capacity, cell_capacity, edge_capacity = (
        mc.round_capacity(int(n)) for n in gmax)
    state = mc.compact_cells(case, active, cell_capacity, variant)
    everts, faces, _ = mc.emit_indexed(
        vol, emask, state, edge_capacity, capacity, cell_capacity,
        z_offset=rank * c, variant=variant)
    return assemble_indexed(everts, faces, total, nedge,
                            return_indexed), per_tile
