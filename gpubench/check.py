"""The comparison that decides ``correct``: a mesh the program returned
against the reference's mesh of the same request.

Every vertex is read in the reference's grid units and named by the grid
edge it lies on: the lower grid point and the edge's axis, or, where it
lies within ``TOL`` steps of a grid point, that point.  Both sides go
through the same naming, so that float32 rounding in another order
(a vertex moved by a few ulps, a grid moved by one float32 ulp) keeps
every name, while a wrong sign, a wrong edge or a wrong triangle does
not.  The numbers compared, per request:

* ``topo_mismatch``: triangles (the names of their three vertices, in
  their orientation) on one side only, both ways, over the reference's
  count;
* ``vert_gap``: the widest distance, in grid steps, between the program's
  and the reference's vertex on the same grid edge, or of a program's
  vertex off every grid edge from the edges;
* ``edge_mismatch``: the grid edges that carry a vertex of the program's
  mesh and do not change sign in the reference's field inside a kept
  cell, plus those that do and carry none, over the latter's count.  It
  needs no table of triangles;
* ``open_edges``: the program's triangle edges (between vertex names)
  that no edge of another triangle meets the other way round, over the
  number of edges: the configuration states a closed, consistently
  oriented surface (Lewiner's marching cubes on a surface the grid
  holds), so the limit is 0.  It needs no table either;
* ``count_gap``, ``area_gap``, ``volume_gap``: the differences of the
  triangle counts, of the surface areas and of the enclosed (signed)
  volumes, each over the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

TOL = 1e-3  # grid steps
_M = 1 << 13  # grid points an axis the names can hold (with a margin)

_M1 = -7046029254386353131  # 0x9E3779B97F4A7C15 as int64
_M2 = -4658895280553007687  # 0xBF58476D1CE4E5B9 as int64
_M3 = -7723592293110705685  # 0x94D049BB133111EB as int64


def _mix(h):
    """A 64-bit finaliser (wrapping int64 arithmetic)."""
    h = h ^ ((h >> 30) & 0x3FFFFFFFF)
    h = h * _M2
    h = h ^ ((h >> 27) & 0x1FFFFFFFFF)
    h = h * _M3
    return h ^ ((h >> 31) & 0x1FFFFFFFF)


def edge_key(lower, axis):
    """The name of grid edge ``(lower (N, 3) int64, axis (N,))``; axis 3
    names the grid point ``lower`` itself."""
    low = lower + 2
    return ((low[:, 0] * _M + low[:, 1]) * _M + low[:, 2]) * 4 + axis


def vertex_keys(u):
    """Names of the vertices ``u`` (N, 3) float64 in grid units, and
    whether each is an edge's (not a point's).  A vertex off every grid
    edge by more than ``2 TOL``, or not finite, gets a negative name of its
    own, which matches nothing, and its distance off the edges (else 0)."""
    r = torch.round(u)
    d = (u - r).abs()
    top, axis = d.max(dim=1)
    off = d.sum(dim=1) - top  # the two other coordinates' distances
    rows = torch.arange(len(u), device=u.device)
    low = r.clone()
    low[rows, axis] = torch.floor(u[rows, axis])
    point = top <= TOL
    low = torch.where(point[:, None], r, low).long()
    key = edge_key(low, torch.where(point, 3, axis))
    bad = ~torch.isfinite(u).all(dim=1)
    off = torch.where(bad, float("inf"), off)
    stray = bad | (off > 2 * TOL)
    key = torch.where(stray, -1 - rows, key)
    return key, ~point & ~stray, torch.where(stray, off, 0.0)


def triangle_keys(k):
    """One int64 a triangle of vertex names ``k`` (T, 3), the same for
    each vertex the triangle may start at."""
    rot = torch.stack([k, k.roll(-1, dims=1), k.roll(-2, dims=1)], dim=1)
    first = rot[..., 0]
    best = first == first.min(dim=1, keepdim=True).values
    second = torch.where(best, rot[..., 1], torch.iinfo(torch.int64).max)
    pick = torch.argmin(second, dim=1)
    r = rot[torch.arange(len(rot), device=rot.device), pick]  # (T, 3)
    return _mix(_mix(_mix(r[:, 0]) * _M1 + r[:, 1]) * _M1 + r[:, 2])


def _missing(a, b):
    """How many of the keys ``a`` have no partner in ``b`` (multisets:
    each key of ``b`` pairs with one of ``a``)."""
    if len(a) == 0:
        return 0
    if len(b) == 0:
        return len(a)
    ua, ca = torch.unique(a, return_counts=True)
    ub, cb = torch.unique(b, return_counts=True)
    at = torch.searchsorted(ub, ua).clamp(max=len(ub) - 1)
    found = ub[at] == ua
    paired = torch.where(found, torch.minimum(ca, cb[at]), 0)
    return int((ca - paired).sum())


def _unpaired(k):
    """How many directed edges of the triangles ``k`` (T, 3) of vertex
    names are not matched by the same edge the other way round (a closed,
    consistently oriented surface has none); edges whose two ends share a
    name are left out."""
    a = k.reshape(-1)
    b = k.roll(-1, dims=1).reshape(-1)
    live = a != b
    a, b = a[live], b[live]
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    sign = torch.where(a < b, 1, -1)
    pair = _mix(_mix(lo) * _M1 + hi)
    u, inv = torch.unique(pair, return_inverse=True)
    bal = torch.zeros(len(u), dtype=torch.int64, device=k.device)
    bal.index_add_(0, inv, sign)
    return int(bal.abs().sum())


def _by_key(keys, u):
    """Sorted unique ``keys`` and the first of their points ``u``."""
    order = torch.argsort(keys, stable=True)
    k = keys[order]
    first = torch.ones_like(k, dtype=torch.bool)
    first[1:] = k[1:] != k[:-1]
    return k[first], u[order][first]


def _area_volume(tri, centre):
    """Surface area and signed enclosed volume of triangles ``tri``
    (T, 3, 3), about ``centre``."""
    if len(tri) == 0:
        return 0.0, 0.0
    tri = tri - centre
    cr = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * torch.linalg.vector_norm(cr, dim=1).sum()
    vol = (torch.linalg.cross(tri[:, 0], tri[:, 1]) * tri[:, 2]).sum() / 6
    return float(area), float(vol)


def _gap(a, b):
    return abs(a - b) / abs(b) if b else float(a != b)


def compare(verts, faces, ref):
    """The numbers compared (module docstring) of the program's mesh
    ``(verts (V, 3) float64 world, faces (T, 3) int)`` (numpy) against the
    reference's ``ref`` (``reference.mesh.mesh``'s dict)."""
    soup = ref["soup"]
    dev = soup.device
    shift = torch.as_tensor(ref["origin"], dtype=torch.float64, device=dev)
    step = float(ref["step"])
    f = torch.as_tensor(np.ascontiguousarray(faces), device=dev).long()
    f = f.reshape(-1)
    up = (torch.as_tensor(np.ascontiguousarray(verts), dtype=torch.float64,
                          device=dev)
          - shift) / step
    kp, ep, off = vertex_keys(up)
    # the vertices the faces use, (3T, 3), named vertex by vertex
    up, kp, ep, off = up[f], kp[f], ep[f], off[f]
    ur = (soup.reshape(-1, 3) - shift) / step
    kr, er, _ = vertex_keys(ur)
    n = max(len(soup), 1)
    tp = triangle_keys(kp.reshape(-1, 3))
    tr = triangle_keys(kr.reshape(-1, 3))
    topo = (_missing(tp, tr) + _missing(tr, tp)) / n

    pk, pu = _by_key(kp[ep], up[ep])
    rk, ru = _by_key(kr[er], ur[er])
    if len(pk) and len(rk):
        at = torch.searchsorted(rk, pk).clamp(max=len(rk) - 1)
        hit = rk[at] == pk
        diff = (pu[hit] - ru[at[hit]]).abs()
        vert_gap = float(diff.max()) if len(diff) else float("inf")
    else:
        vert_gap = float("inf") if len(pk) or len(rk) else 0.0
    if len(off):
        vert_gap = max(vert_gap, float(off.max()))
    # Program vertices off every grid edge count against the edges too.
    stray = int((kp < 0).sum())
    expected = ref["edges"]
    edge = (_missing(pk, expected) + _missing(expected, pk) + stray) / max(
        len(expected), 1)

    open_edges = _unpaired(kp.reshape(-1, 3)) / max(len(f), 1)

    centre = ur.mean(dim=0) if len(ur) else 0.0
    ap, vp = _area_volume(up.reshape(-1, 3, 3), centre)
    ar, vr = _area_volume(ur.reshape(-1, 3, 3), centre)
    return {"topo_mismatch": topo, "vert_gap": vert_gap,
            "edge_mismatch": edge, "open_edges": open_edges,
            "count_gap": _gap(len(f) // 3, len(soup)),
            "area_gap": _gap(ap, ar), "volume_gap": _gap(vp, vr)}
