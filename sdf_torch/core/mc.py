"""Marching cubes on tensors (counterpart of ``sdf_tpu.core.mc``).

Two phases with one host sync between them, as in the JAX package:

  * ``count_indexed``: per-cell triangle counts (kernel B3, ``ntri_of``)
    under the cull mask, per-tile totals and the crossing-edge mask --
    every count the host needs, fetched together;
  * ``gather_emit_indexed``: given capacities from ``round_capacity``,
    compact the active cells (kernel B4) and the crossing edges (kernel B5),
    interpolate one vertex per edge and resolve each triangle's three edge
    ids to compacted vertex ranks.

The triangle-soup form of the JAX package (``count``, ``emit``,
``interpolate_slots``) serves the differentiable path: the same kernels
(B2, B3, B4) give its integer parts, and torch indexing and arithmetic its
vertices, so autograd reaches the volume.

Vertices are fractional index coordinates; the engine maps them to world
space.  Two table bundles: "lewiner" (generate()'s default: 5,904 extended
codes from ``mc33.classify_ext``, up to 10 triangles a cell) and the fixed
separated-ambiguity tables ("fast", internal name "default": 256 codes, up
to 5 triangles).  Both run through the same code; only the table sizes and
the case-code width differ.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..ops.vecmath import clip
from . import compact
from .mc_tables import CORNER_OFFSETS, EDGE_CORNERS, NTRI_TABLE, TRI_TABLE
from .node import upload

def round_capacity(n):
    """Buffer capacity for ``n`` items: the next power of two or 1.5x a
    power of two (the JAX package's sizes, so padded outputs match)."""
    n = max(1, int(n))
    p = 1 << (n - 1).bit_length()
    if n <= (p // 2) + (p // 4):
        return (p // 2) + (p // 4)
    return p


class Tables:
    """Per-variant case-table bundle: ``"default"`` is the fixed
    separated-ambiguity rule (mc_tables), ``"lewiner"`` the trilinear-
    faithful extended tables (mc33), whose case codes carry face-saddle and
    interior bits -- same code paths, wider tables."""

    def __init__(self, name, tri_table, ntri_table):
        self.name = name
        tri_table = np.asarray(tri_table, np.int32)
        self.tri = tri_table  # (ncase, max_tris, 3), -1 padded
        self.ntri = np.asarray(ntri_table, np.int32)
        # The counts as bytes for kernel B3 (at most 10 triangles a cell),
        # padded to a multiple of 16 for its 16-byte table copy.
        if self.ntri.min() < 0 or self.ntri.max() > 255:
            raise ValueError("triangle counts must fit a byte")
        self.ntri_u8 = np.zeros(-(-self.ntri.size // 16) * 16, np.uint8)
        self.ntri_u8[: self.ntri.size] = self.ntri
        self.ncase = tri_table.shape[0]
        self.max_tris = tri_table.shape[1]
        self.nsv = self.max_tris * 3  # slot vertices a cell
        self.case_bits = int(self.ncase - 1).bit_length()
        self.tf3 = np.maximum(tri_table, 0)  # padding clamped to edge 0
        # (ncase * max_tris,) packed 3x4-bit cube-edge ids per (case, slot).
        self.eid_pack = (
            self.tf3[:, :, 0] | (self.tf3[:, :, 1] << 4)
            | (self.tf3[:, :, 2] << 8)
        ).reshape(-1).astype(np.int32)
        # The soup emit's per-case interpolation table (``interpolate_slots``):
        # [ca | cb | pax pay paz | pbx pby pbz], each nsv wide: the corner
        # numbers of each slot vertex's edge and their offsets in the cell.
        flat = self.tf3.reshape(self.ncase, -1)
        ca = EDGE_CORNERS[flat, 0]
        cb = EDGE_CORNERS[flat, 1]
        self.wide_pack = np.concatenate(
            [
                ca,
                cb,
                CORNER_OFFSETS[ca].transpose(0, 2, 1).reshape(self.ncase, -1),
                CORNER_OFFSETS[cb].transpose(0, 2, 1).reshape(self.ncase, -1),
            ],
            axis=1,
        ).astype(np.float64)
        self._dev = {}

    def classify(self, volume, level=0.0):
        """Per-cell case codes for this variant."""
        if self.name == "default":
            return _cell_cases(volume, level)
        from . import mc33

        return mc33.classify_ext(volume, level)

    def on(self, device, name, dtype=None):
        """A table as a tensor on ``device`` (cached): uint8 for the byte
        tables, int32 for the others unless ``dtype`` says otherwise."""
        key = (str(device), name, dtype)
        if key not in self._dev:
            a = getattr(self, name)
            if dtype is None:
                dtype = torch.uint8 if a.dtype == np.uint8 else torch.int32
            self._dev[key] = upload([a], dtype, device)[0]
        return self._dev[key]

    def __repr__(self):
        return f"Tables({self.name!r})"


_TABLES = {}


def get_tables(variant="default"):
    """The cached table bundle for an MC variant name: "lewiner" is
    generate()'s default, "fast" the user-facing spelling of "default"."""
    if variant == "fast":
        variant = "default"
    if variant not in _TABLES:
        if variant == "default":
            _TABLES[variant] = Tables("default", TRI_TABLE, NTRI_TABLE)
        elif variant == "lewiner":
            from . import mc33

            d = mc33.load_tables()
            _TABLES[variant] = Tables("lewiner", d["tri_table"], d["ntri"])
        else:
            raise ValueError(
                f"unknown mc_variant {variant!r}: use 'lewiner' (the "
                "default) or 'fast' ('default' is a legacy alias of 'fast')"
            )
    return _TABLES[variant]


# --- kernel B3: ntri lookup --------------------------------------------------


# Kernel B3's launch plan (csrc/ntri.cu NTHREADS, BLOCKS_PER_SM).
_NTRI_THREADS = 256
_NTRI_BLOCKS_PER_SM = 8


def _ntri_lib():
    lib = _build.load("ntri", _build.source("ntri.cu"))
    if not getattr(lib, "_sdf_typed", False):
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.sdf_ntri.argtypes = [vp, i64, i, i64, i, vp, i, vp, vp]
        lib.sdf_ntri.restype = ctypes.c_int
        lib._sdf_typed = True
    return lib


def ntri_plan(address, n, sms):
    """Kernel B3's launch plan for ``n`` int32 codes at device address
    ``address`` on a card of ``sms`` SMs: ``(head, nvec, tail, blocks)``.
    The first ``head`` codes reach the first 16-byte boundary, ``nvec``
    vectors of 4 follow, then ``tail`` (at most 3) codes; ``blocks`` is the
    SMs times the blocks that fit on one, or fewer when there are fewer
    vectors than their lanes."""
    if address % 4:
        raise ValueError("ntri_of: int32 codes at an address that is not a "
                         "multiple of 4")
    head = min(n, (-address % 16) // 4)
    nvec = (n - head) // 4
    tail = n - head - 4 * nvec
    blocks = max(1, min(sms * _NTRI_BLOCKS_PER_SM,
                        -(-nvec // _NTRI_THREADS)))
    return head, nvec, tail, blocks


def _like_at(t, address):
    """An empty int32 tensor of ``t``'s shape and device whose address has
    ``address``'s remainder modulo 16 (``address`` a multiple of 4)."""
    n = t.numel()
    buf = torch.empty(n + 3, dtype=torch.int32, device=t.device)
    at = (address - buf.data_ptr()) % 16 // 4
    return buf[at: at + n].view(t.shape)


def _ntri_plain(case, table):
    """B3's plain version: ``table[case]``, 0 outside the table."""
    ok = (case >= 0) & (case < table.numel())
    return torch.where(ok, table[case.clamp(0, table.numel() - 1).long()], 0)


def ntri_of(case, variant="default"):
    """Per-cell triangle counts ``ntri[case]`` (int32, the shape of
    ``case``).  Kernel B3 on CUDA, the plain lookup on the CPU."""
    if case.dtype != torch.int32:
        raise ValueError("case codes must be int32")
    tab = get_tables(variant)
    if case.device.type == "cpu":
        return _ntri_plain(case, tab.on(case.device, "ntri")).to(torch.int32)
    _build.require_cuda(case, "ntri_of")
    n = case.numel()
    if not n:
        return torch.empty_like(case)
    address = case.data_ptr()
    sms = torch.cuda.get_device_properties(case.device).multi_processor_count
    head, nvec, _, blocks = ntri_plan(address, n, sms)
    out = _like_at(case, address)
    table = tab.on(case.device, "ntri_u8")
    _build.check(
        _ntri_lib().sdf_ntri(
            address, n, head, nvec, blocks, table.data_ptr(), tab.ncase,
            out.data_ptr(), _build.stream_ptr(case.device),
        ),
        "ntri",
    )
    ntri_of.launches += 1
    return out


ntri_of.launches = 0


def _cell_cases(volume, level=0.0):
    """Case index per cell: bit c set iff corner c is inside (< level).
    ``volume`` is (..., nx, ny, nz): leading dims are a batch (of tiles)."""
    nx, ny, nz = volume.shape[-3:]
    case = torch.zeros(tuple(volume.shape[:-3]) + (nx - 1, ny - 1, nz - 1),
                       dtype=torch.int32, device=volume.device)
    for c, (ox, oy, oz) in enumerate(CORNER_OFFSETS.tolist()):
        corner = volume[..., ox: nx - 1 + ox, oy: ny - 1 + oy,
                        oz: nz - 1 + oz]
        case |= (corner < level).to(torch.int32) << c
    return case


# --- triangle-soup emit ------------------------------------------------------
#
# The differentiable path (``core.diffmesh``) meshes through these: only the
# corner gather and the lerp carry gradients; case codes (kernel B2 or the
# corner compares), counts (B3) and the compacted cell indices (B4) are
# integers computed from the detached volume.


def _gather_corners(volume, ci, cj, ck):
    """The 8 corner values of each listed cell, as 8 1D tensors (one
    gather of the flattened volume, differentiable)."""
    nx, ny, nz = volume.shape
    lin0 = (ci * ny + cj) * nz + ck
    doff = [(ox * ny + oy) * nz + oz for ox, oy, oz in CORNER_OFFSETS.tolist()]
    idx = torch.cat([lin0 + d for d in doff])
    return list(_take(volume.reshape(-1), 0, idx).reshape(8, -1))


def _take(src, dim, idx):
    """``src`` indexed by the 1D ``idx`` along ``dim``, differentiable.
    ``index_select``, whose backward adds with ``index_add_``: the padding
    of a compacted list repeats one index hundreds of thousands of times,
    which advanced indexing's backward (a sort, then a serial sum of each
    run of equal indices) spends tens of ms on, on the card."""
    return torch.index_select(src, dim, idx)


def _classify(volume, variant):
    """Case codes of the detached volume: integers, constant under
    differentiation (kernel B2 under lewiner on the card)."""
    return get_tables(variant).classify(volume.detach().contiguous())


def count(volume, cell_mask, tile, case=None, variant="default"):
    """Phase 1 of the soup emit: ``(total_triangles, per_tile_counts,
    active_cells, case_codes)`` (see sdf_tpu.core.mc.count).  ``cell_mask``
    zeroes culled cells; ``tile`` is the cell tile size; ``case=`` takes
    precomputed codes."""
    if case is None:
        case = _classify(volume, variant)
    ntri = ntri_of(case, variant) * cell_mask.to(torch.int32)
    cx, cy, cz = ntri.shape
    px, py, pz = (-cx) % tile, (-cy) % tile, (-cz) % tile
    padded = torch.nn.functional.pad(ntri, (0, pz, 0, py, 0, px))
    tx, ty, tz = (cx + px) // tile, (cy + py) // tile, (cz + pz) // tile
    per_tile = padded.reshape(tx, tile, ty, tile, tz, tile).sum(dim=(1, 3, 5))
    return ntri.sum(), per_tile, (ntri > 0).sum(), case


def emit(volume, cell_mask, capacity, cell_capacity=None, case=None,
         variant="default", z_offset=0):
    """Phase 2 of the soup emit: ``(verts (9, capacity), n_tris)`` in
    fractional index coordinates, row ``v * 3 + c`` holding component c of
    vertex v, triangles in ascending (cell, slot) order; columns
    ``[0:n_tris]`` are valid (see sdf_tpu.core.mc.emit).  Two-level
    compaction: the active cells first (kernel B4), then their slots
    (``compact.ragged_expand``).  Gradients reach ``volume`` through the
    corner gather and the lerp.  ``z_offset`` shifts the integer z of every
    cell before the float interpolation (a z slab's vertices in the global
    grid, bit-equal to a run over the whole grid)."""
    if cell_capacity is None:
        # n_active_cells <= n_triangles: the triangle capacity bounds it.
        cell_capacity = capacity
    if case is None:
        case = _classify(volume, variant)
    ntri = ntri_of(case, variant) * cell_mask.to(torch.int32)
    cell_idx, n_cells = compact.indices_of((ntri > 0).reshape(-1),
                                           cell_capacity)
    cell_idx = cell_idx.to(torch.int64)
    cell_live = torch.arange(cell_capacity, device=case.device) < n_cells
    _, cy, cz = case.shape
    ci = cell_idx // (cy * cz)
    cj = (cell_idx // cz) % cy
    ck = cell_idx % cz
    cell_case = case.reshape(-1)[cell_idx]
    cell_ntri = torch.where(cell_live, ntri.reshape(-1)[cell_idx], 0)
    corner = _gather_corners(volume, ci, cj, ck)
    base = (ci.to(volume.dtype), cj.to(volume.dtype),
            (ck + z_offset).to(volume.dtype))
    return interpolate_slots(corner, base, cell_case, cell_ntri, capacity,
                             cell_capacity, variant)


def interpolate_slots(corner, base, cell_case, cell_ntri, capacity,
                      cell_capacity, variant="default"):
    """The soup emit's tail, shared with the tiles' ``sparse._emit_tiles``:
    every slot vertex of every listed cell interpolated on its edge, then
    the live (cell, slot) pairs expanded in order.  ``corner``: 8
    ``(cell_capacity,)`` corner values; ``base``: 3 cell base coordinates.
    Returns ``(verts (9, capacity), n_tris)``.

    The JAX package's op order, term for term, so float64 outputs match:
    the corner value of a slot's edge end is ``sum((ca == c) * cn[:, c])``,
    then ``t = va / where(denom == 0, 1, denom)``, clipped to [0, 1] (a tie
    splits its gradient, as ``jnp.clip``'s does), then ``bs + pa + t * (pb
    - pa)``.  One pass over all cells: the JAX package's chunks exist for
    the TPU's 128-lane padding of the (cells, 3 * max_tris) temporaries,
    which a card does not pad."""
    tab = get_tables(variant)
    N = tab.nsv
    cn = torch.stack(corner, dim=1)  # (cell_capacity, 8)
    p = tab.on(cn.device, "wide_pack", cn.dtype)[cell_case.to(torch.int64)]
    ca = p[:, 0:N]
    cb = p[:, N: 2 * N]
    va = sum((ca == c) * cn[:, c][:, None] for c in range(8))
    vb = sum((cb == c) * cn[:, c][:, None] for c in range(8))
    denom = va - vb
    t = clip(va / torch.where(denom == 0, 1.0, denom), 0.0, 1.0)
    outs = []
    for c in range(3):
        pa = p[:, (2 + c) * N: (3 + c) * N]
        pb = p[:, (5 + c) * N: (6 + c) * N]
        outs.append(base[c][:, None] + pa + t * (pb - pa))
    # Columns [c * N + slot * 3 + v] -> rows v * 3 + c, each holding the
    # slot-major blocks [slot * cell_capacity + cell].
    wide = torch.cat(outs, dim=1).T.reshape(3, tab.max_tris, 3, cell_capacity)
    staged = wide.permute(2, 0, 1, 3).reshape(9, tab.max_tris * cell_capacity)
    ctri, slot, n_tris = compact.ragged_expand(cell_ntri, capacity)
    return _take(staged, 1, slot * cell_capacity + ctri), n_tris


# --- indexed emit --------------------------------------------------------------

# Per cube edge: its axis and the (coordinate-wise lower) origin corner.
_EDGE_AXIS = np.argmax(
    CORNER_OFFSETS[EDGE_CORNERS[:, 1]] - CORNER_OFFSETS[EDGE_CORNERS[:, 0]],
    axis=1,
).astype(np.int64)
_EDGE_ORIG = CORNER_OFFSETS[EDGE_CORNERS[:, 0]].astype(np.int64)  # (12, 3)
_EDGE_DEV = {}  # device -> (axis, origin) tensors


def _edge_tables(device):
    key = str(device)
    if key not in _EDGE_DEV:
        _EDGE_DEV[key] = tuple(upload([_EDGE_AXIS, _EDGE_ORIG], torch.int64,
                                      device))
    return _EDGE_DEV[key]


def _edge_ids_of(case_t, slot, variant="default"):
    """Cube-edge ids of the three vertices of triangle ``slot`` of cell
    case ``case_t``: three int64 tensors from the packed 3x4-bit table."""
    tab = get_tables(variant)
    packed = tab.on(case_t.device, "eid_pack")[case_t * tab.max_tris + slot]
    return [((packed >> (4 * v)) & 15).to(torch.int64) for v in range(3)]


def _edge_gid(e, cx, cy, cz, ny, nz, Sx, Sy):
    """Global edge id of cube edge ``e`` of the cell at ``(cx, cy, cz)``.
    Edge ids: x-edges (nx-1, ny, nz), then y-edges (nx, ny-1, nz), then
    z-edges (nx, ny, nz-1), back to back."""
    axis_t, orig_t = _edge_tables(e.device)
    axis = axis_t[e]
    orig = orig_t[e]  # (n, 3)
    x = cx + orig[:, 0]
    y = cy + orig[:, 1]
    z = cz + orig[:, 2]
    my = torch.where(axis == 1, ny - 1, ny)
    mz = torch.where(axis == 2, nz - 1, nz)
    base = torch.where(axis == 0, 0, torch.where(axis == 1, Sx, Sx + Sy))
    return base + (x * my + y) * mz + z


def _gid_pack(strides, bases, variant="default"):
    """Per (case, slot): edge-id coefficients for the three vertices, as
    one (ncase * max_tris, 9) int64 numpy table.

    A vertex's edge id is affine in its cell coordinates: ``gid = cx * sx +
    cy * sy + cz + K``, where (sx, sy, K) depend only on the edge's axis
    and origin-corner offset.  ``strides[a] = (sx, sy)`` and ``bases[a]``
    give each axis' edge-grid layout.  Row layout: ``[sx0 sy0 K0 sx1 sy1 K1
    sx2 sy2 K2]``.  The tiled path uses it with tile-local strides."""
    tab = get_tables(variant)
    strides = np.asarray(strides, np.int64)
    bases = np.asarray(bases, np.int64)
    ax = _EDGE_AXIS[tab.tf3]  # (ncase, max_tris, 3)
    o = _EDGE_ORIG[tab.tf3]  # (ncase, max_tris, 3, 3)
    sx = strides[ax, 0]
    sy = strides[ax, 1]
    k = bases[ax] + o[..., 0] * sx + o[..., 1] * sy + o[..., 2]
    return np.stack([sx, sy, k], axis=-1).reshape(tab.ncase * tab.max_tris, 9)


def _edge_mask(volume, active):
    """Flat bool mask over all grid edges: sign-crossing AND adjacent to an
    active cell (so culled regions contribute no stray vertices)."""
    sign = volume < 0

    def adj(a, axes):
        # Dilate the active-cell mask by one cell along the two axes
        # orthogonal to the edge direction: an edge touches up to 4 cells.
        shape = list(a.shape)
        for ax in axes:
            shape[ax] += 2
        b = torch.zeros(shape, dtype=torch.bool, device=a.device)
        inner = [slice(None)] * 3
        for ax in axes:
            inner[ax] = slice(1, shape[ax] - 1)
        b[tuple(inner)] = a
        for ax in axes:
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[ax] = slice(0, b.shape[ax] - 1)
            hi[ax] = slice(1, None)
            b = b[tuple(lo)] | b[tuple(hi)]
        return b

    ex = (sign[:-1] != sign[1:]) & adj(active, (1, 2))
    ey = (sign[:, :-1] != sign[:, 1:]) & adj(active, (0, 2))
    ez = (sign[:, :, :-1] != sign[:, :, 1:]) & adj(active, (0, 1))
    return torch.cat([ex.reshape(-1), ey.reshape(-1), ez.reshape(-1)])


def compact_cells(case, active, cell_capacity, variant="default"):
    """Compact the active cells (kernel B4, then B3 on the survivors).
    Returns ``(ci, cj, ck, cell_case, cell_ntri)``, each
    ``(cell_capacity,)``: int64 coordinates, int32 case and count."""
    cshape = case.shape
    aflat = active.reshape(-1)
    cell_idx, n_cells = compact.indices_of(aflat, cell_capacity)
    live = torch.arange(cell_capacity, device=case.device) < n_cells
    cell_idx = cell_idx.to(torch.int64)
    cell_case = case.reshape(-1)[cell_idx]
    cell_ntri = torch.where(live, ntri_of(cell_case, variant), 0)
    _, cy, cz = cshape
    ci = cell_idx // (cy * cz)
    cj = (cell_idx // cz) % cy
    ck = cell_idx % cz
    return ci, cj, ck, cell_case, cell_ntri.to(torch.int32)


def count_indexed(volume, case, keep, tile, tshape, variant="default"):
    """Phase 1: every count the host needs.  Returns ``(n_cells,
    total_tris, n_edges, per_tile, active, emask)``; the first four are
    device tensors to fetch in ONE transfer, the last two stay for
    ``gather_emit_indexed``."""
    ntri_all = ntri_of(case, variant)
    # Which codes emit nothing is per table: the 8-bit cases 0 and 255 of the
    # default tables, and every extended code under them in the lewiner set.
    active = keep & (ntri_all > 0)
    ntri = ntri_all * active.to(torch.int32)
    cx, cy, cz = ntri.shape
    px, py, pz = (-cx) % tile, (-cy) % tile, (-cz) % tile
    padded = torch.zeros((cx + px, cy + py, cz + pz), dtype=torch.int64,
                         device=ntri.device)
    padded[:cx, :cy, :cz] = ntri
    tx, ty, tz = tshape
    per_tile = padded.reshape(tx, tile, ty, tile, tz, tile).sum(dim=(1, 3, 5))
    emask = _edge_mask(volume, active)
    return (
        active.sum(),
        ntri.sum(dtype=torch.int64),
        emask.sum(),
        per_tile,
        active,
        emask,
    )


def gather_emit_indexed(volume, case, active, emask, edge_capacity, capacity,
                        cell_capacity, packed=False, variant="default"):
    """Phases 2+3: cell compaction + indexed emit, no host sync.

    ``packed`` selects the wire format (see ``emit_indexed_packed``):
    False = plain ``(everts, faces)``; True = packed with 21-bit faces;
    ``"wide"`` = packed vertices but plain faces.  float32 only when not
    False."""
    state = compact_cells(case, active, cell_capacity, variant)
    if packed is not False:
        return emit_indexed_packed(
            volume, emask, state, edge_capacity, capacity, cell_capacity,
            pack_faces=(packed is True), variant=variant,
        )
    everts, faces, _ = emit_indexed(
        volume, emask, state, edge_capacity, capacity, cell_capacity,
        variant=variant,
    )
    return everts, faces


def _emit_indexed_core(volume, emask, cell_state, edge_capacity, capacity,
                       cell_capacity, z_offset=0, variant="default"):
    """Per-edge ``(eidx, ax, exyz, t)`` plus resolved ``faces (3,
    capacity)`` and ``n_tris`` (see sdf_tpu.core.mc._emit_indexed_core).

    ``z_offset`` is added to the integer z of every edge, before the float
    interpolation add: a sharded slab's vertices are then bit-identical to
    a run over the global grid (adding it to ``z + t`` afterwards rounds
    differently).  The volume gather uses the slab-local z."""
    nx, ny, nz = volume.shape
    Sx = (nx - 1) * ny * nz
    Sy = nx * (ny - 1) * nz

    eidx, ranktab, _ = compact.indices_and_ranktable_of(emask, edge_capacity)
    e = eidx.to(torch.int64)
    ax = (e >= Sx).to(torch.int64) + (e >= Sx + Sy).to(torch.int64)

    def decode(local, My, Mz):
        z = local % Mz
        rem = local // Mz
        return rem // My, rem % My, z

    d0 = decode(e, ny, nz)
    d1 = decode(e - Sx, ny - 1, nz)
    d2 = decode(e - Sx - Sy, ny, nz - 1)

    def pick(i):
        return torch.where(ax == 0, d0[i], torch.where(ax == 1, d1[i], d2[i]))

    ex, ey, ez = pick(0), pick(1), pick(2)

    vflat = volume.reshape(-1)
    lin_a = (ex * ny + ey) * nz + ez
    vstride = torch.where(ax == 0, ny * nz, torch.where(ax == 1, nz, 1))
    va = vflat[lin_a]
    vb = vflat[lin_a + vstride]
    denom = va - vb
    # The zero-crossing formula of the JAX package, term for term.
    t = torch.clamp(
        torch.clamp(va / torch.where(denom == 0, 1.0, denom), min=0.0), max=1.0
    )

    faces, n_tris = _resolve_faces(
        ranktab, cell_state, capacity, cell_capacity, ny, nz, Sx, Sy, variant
    )
    return eidx, ax, (ex, ey, ez + z_offset), t, faces, n_tris


def emit_indexed(volume, emask, cell_state, edge_capacity, capacity,
                 cell_capacity, z_offset=0, variant="default"):
    """Unique vertices + int32 faces: ``(everts (3, edge_capacity),
    faces (3, capacity), n_tris)``; ``everts.T[faces.T.reshape(-1)]`` is the
    triangle soup.  ``z_offset``: see ``_emit_indexed_core``."""
    dtype = volume.dtype
    _, ax, (ex, ey, ez), t, faces, n_tris = _emit_indexed_core(
        volume, emask, cell_state, edge_capacity, capacity, cell_capacity,
        z_offset, variant,
    )
    everts = torch.stack(
        [
            ex.to(dtype) + t * (ax == 0).to(dtype),
            ey.to(dtype) + t * (ax == 1).to(dtype),
            ez.to(dtype) + t * (ax == 2).to(dtype),
        ],
        dim=0,
    )
    return everts, faces, n_tris


def _face_branch(ncells, cbits):
    """Which per-triangle cell lookup ``_resolve_faces`` uses: 0 packs the
    cell index and case in one word, 1 packs the cell index and gathers the
    case, 2 gathers all four (grids past 2^31 cells)."""
    if ncells < (1 << (31 - cbits)):
        return 0
    if ncells < (1 << 31):
        return 1
    return 2


def _resolve_faces(ranktab, cell_state, capacity, cell_capacity, ny, nz,
                   Sx, Sy, variant="default"):
    """Face resolution: per-triangle global edge ids -> compacted ranks
    (the three branches of sdf_tpu.core.mc._resolve_faces, chosen by the
    same bounds; all give the same faces)."""
    ci, cj, ck, cell_case, cell_ntri = cell_state
    cbits = get_tables(variant).case_bits
    nx1 = Sx // (ny * nz)
    ny1, nz1 = ny - 1, nz - 1
    branch = _face_branch(nx1 * ny1 * nz1, cbits)
    cell_case = cell_case.to(torch.int64)
    if branch == 0:
        w = ((ci * ny1 + cj) * nz1 + ck) * (1 << cbits) + cell_case
        _, slot, n_tris, wt = compact.ragged_expand(cell_ntri, capacity,
                                                    fill=w)
        case_t = wt & ((1 << cbits) - 1)
        lin = wt >> cbits
    elif branch == 1:
        lin = (ci * ny1 + cj) * nz1 + ck
        ctri, slot, n_tris, lin = compact.ragged_expand(cell_ntri, capacity,
                                                        fill=lin)
        case_t = cell_case[ctri]
    else:
        ctri, slot, n_tris = compact.ragged_expand(cell_ntri, capacity)
        cellpack = torch.cat([ci, cj, ck, cell_case])
        cd = cellpack[
            torch.cat([ctri + i * cell_capacity for i in range(4)])
        ]
        cx = cd[:capacity]
        cy = cd[capacity: 2 * capacity]
        cz = cd[2 * capacity: 3 * capacity]
        case_t = cd[3 * capacity:]
    if branch != 2:
        cx = lin // (ny1 * nz1)
        rem = lin % (ny1 * nz1)
        cy = rem // nz1
        cz = rem % nz1

    ev = _edge_ids_of(case_t, slot, variant)
    gids = [_edge_gid(ev[v], cx, cy, cz, ny, nz, Sx, Sy) for v in range(3)]
    faces = compact.rank_lookup(ranktab, torch.cat(gids)).reshape(3, capacity)
    return faces, n_tris


# ---------------------------------------------------------------------------
# Packed readback: vertices travel as (edge id, t bit pattern) and faces as
# two 32-bit words holding three 21-bit ranks whenever the vertex count fits
# 21 bits.  The device computes the words as int32 bit patterns; the host
# views them as uint32 (torch's uint32 support is thin).
# ---------------------------------------------------------------------------

FACE_PACK_BITS = 21  # 3 * 21 = 63 bits across two words; ne < 2^21


def emit_indexed_packed(volume, emask, cell_state, edge_capacity, capacity,
                        cell_capacity, pack_faces, variant="default"):
    """``emit_indexed`` with the wire-format outputs.  Returns ``(epack (2,
    edge_capacity) int32, fpack (2 or 3, capacity) int32)``, each the bit
    pattern of the JAX package's uint32 arrays; decode with
    ``unpack_indexed`` after ``.view(np.uint32)``.  float32 volumes only."""
    if volume.dtype != torch.float32:
        raise ValueError("packed emit needs a float32 volume")
    eidx, _, _, t, faces, _ = _emit_indexed_core(
        volume, emask, cell_state, edge_capacity, capacity, cell_capacity,
        variant=variant,
    )
    epack = torch.stack([eidx.to(torch.int32), t.view(torch.int32)], dim=0)
    return epack, pack_faces_words(faces, pack_faces)


def pack_faces_words(faces, pack_faces):
    """The face wire format of ``(3, capacity)`` vertex ranks: two words
    holding three 21-bit ranks when ``pack_faces``, else the int32 ranks."""
    if not pack_faces:
        return faces.to(torch.int32)
    f = faces.to(torch.int64)
    B = FACE_PACK_BITS
    lo_mask = (1 << (32 - B)) - 1  # low 11 bits of f1
    w0 = (f[0] | ((f[1] & lo_mask) << B)) & 0xFFFFFFFF
    w1 = ((f[1] >> (32 - B)) | (f[2] << (2 * B - 32))) & 0xFFFFFFFF
    return compact._to_i32(torch.stack([w0, w1], dim=0))


def unpack_indexed(epack, fpack, grid_shape, dtype=np.float32):
    """Host-side decode of ``emit_indexed_packed`` outputs (numpy uint32,
    already sliced to live counts).  Returns ``(vh (ne, 3) float64, fh (n, 3)
    int32)``, bit-identical to slicing ``emit_indexed``'s outputs."""
    nx, ny, nz = grid_shape
    Sx = (nx - 1) * ny * nz
    Sy = nx * (ny - 1) * nz
    eidx = epack[0].astype(np.int64)
    t = epack[1].view(np.float32) if epack.dtype == np.uint32 else epack[1]

    # eidx ascends (compaction preserves order), so the three axis blocks
    # are contiguous slices.
    b0, b1 = np.searchsorted(eidx, [Sx, Sx + Sy])
    ft = np.dtype(dtype)
    vh32 = np.empty((len(eidx), 3), dtype=ft)
    for a, (sl, base, My, Mz) in enumerate(
        (
            (slice(0, b0), 0, ny, nz),
            (slice(b0, b1), Sx, ny - 1, nz),
            (slice(b1, None), Sx + Sy, ny, nz - 1),
        )
    ):
        local = eidx[sl] - base
        z = local % Mz
        rem = local // Mz
        exyz = (rem // My, rem % My, z)
        for c in range(3):
            # Same op order and precision as the device: base in f32 + t.
            comp = exyz[c].astype(ft)
            if c == a:
                comp = comp + t[sl].astype(ft)
            vh32[sl, c] = comp
    vh = vh32.astype(np.float64)

    return vh, unpack_faces(fpack)


def unpack_faces(fpack):
    """Host decode of the (2|3, n) uint32 face wire format -> (n, 3) int32."""
    if fpack.shape[0] == 3:
        return fpack.T.astype(np.int32)
    B = FACE_PACK_BITS
    w0 = fpack[0].astype(np.uint64)
    w1 = fpack[1].astype(np.uint64)
    m = np.uint64((1 << B) - 1)
    f0 = w0 & m
    f1 = ((w0 >> np.uint64(B)) | (w1 << np.uint64(32 - B))) & m
    f2 = (w1 >> np.uint64(2 * B - 32)) & m
    return np.stack([f0, f1, f2], axis=1).astype(np.int32)
