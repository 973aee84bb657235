"""The plain reference mesher: the same semantics as the program's
``generate(f, samples=N, output="mesh")`` at its defaults (float32,
``sparse=True``, ``mc_variant="lewiner"``, batches of 32 cells), worked out
again from the expression alone with plain torch operations.

What it derives, in order: the bounds (the reference's 16^3 probe-grid
refinement, evaluated on the CPU in the compute dtype with float64 loop
state), the grid, the per-batch probe cull (centre and 8 corners of each
batch, evaluated on the device), whether the cull would route the call to
the tiles, the field at every sample (in blocks of x planes), each kept
cell's corner case and lewiner bits (the bilinear face test and the
guarded trilinear interior test), the extended case code, and the
triangles of the frozen lewiner tables with their vertices interpolated on
the grid edges.  The soup it returns is what the program's mesh is
compared with (``check.py``), with the grid edges on which a vertex is
due: those whose ends differ in sign inside a kept cell, worked out from
the field alone.

Nothing here imports the program.  The lewiner tables are a frozen copy
(``lewiner_tables.npz``, four arrays of the table set the program ships),
and the interior test is the same formula as the program's: the
triangles are not independent of the program's table set, which is why
the check also holds the program's vertices to the edges due, which need
no table.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from check import TOL, edge_key

from .sdf import Points, field, sqrt

BATCH = 32
AUTO_TILES_THRESHOLD = 0.6
GUARD_ULPS = 64.0
_CHUNK_POINTS = 2**22

# Corner numbering (x, y, z offsets): bit c of a case is corner c inside.
CORNERS = np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)])
# Cube edges as (corner a, corner b), a the coordinate-wise smaller corner.
EDGES = np.array([(0, 1), (1, 2), (3, 2), (0, 3), (4, 5), (5, 6), (7, 6),
                  (4, 7), (0, 4), (1, 5), (2, 6), (3, 7)])
# Each face's 4 corners, counter-clockwise seen from outside.
FACES = [[0, 3, 2, 1], [4, 5, 6, 7], [0, 1, 5, 4],
         [3, 7, 6, 2], [0, 4, 7, 3], [1, 2, 6, 5]]


@functools.lru_cache()
def tables():
    """``tri_table`` (5904, 10, 3) int64, ``ntri`` (5904,), ``offset``
    (256,), ``weight`` (256, 6), as numpy int64."""
    with np.load(Path(__file__).with_name("lewiner_tables.npz")) as z:
        return {k: z[k].astype(np.int64) for k in z.files}


def bounds(expr, dtype=torch.float32):
    """``(lo, hi)``: up to 32 refinements of a 16^3 probe grid on the CPU,
    loop state in float64, a 1e-4 slack in float32."""
    s = 16
    slack = 0.0 if dtype == torch.float64 else 1e-4
    lo = np.full(3, -1e9)
    hi = np.full(3, 1e9)
    prev = None
    empty = True
    f = field(expr, dtype, "cpu")
    for _ in range(32):
        X = np.linspace(lo[0], hi[0], s)
        Y = np.linspace(lo[1], hi[1], s)
        Z = np.linspace(lo[2], hi[2], s)
        d = np.array([X[1] - X[0], Y[1] - Y[0], Z[1] - Z[0]])
        threshold = np.linalg.norm(d) / 2
        if threshold == prev:
            break
        prev = threshold
        Xt, Yt, Zt = [torch.as_tensor(a, dtype=dtype) for a in (X, Y, Z)]
        p = Points(Xt[:, None, None], Yt[None, :, None], Zt[None, None, :])
        vol = torch.as_tensor(f(p)).broadcast_to((s, s, s))
        vol = vol.to(torch.float64).numpy()
        where = np.argwhere(np.abs(vol) <= threshold * (1 + slack))
        if len(where) == 0:
            break
        empty = False
        hi = lo + where.max(axis=0) * d + d / 2
        lo = lo + where.min(axis=0) * d - d / 2
    if empty:
        raise ValueError("no surface found")
    return tuple(lo.tolist()), tuple(hi.tolist())


def grid(expr, samples, dtype=torch.float32):
    """The sample axes ``(X, Y, Z)`` (host float64) and the step."""
    (x0, y0, z0), (x1, y1, z1) = bounds(expr, dtype)
    step = ((x1 - x0) * (y1 - y0) * (z1 - z0) / samples) ** (1 / 3)
    return (np.arange(x0, x1, step), np.arange(y0, y1, step),
            np.arange(z0, z1, step), step)


def _upload(arrays, dtype, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype).reshape(
        np.shape(a)).to(device) for a in arrays]


def _batch_slices(n, size):
    return [(i, min(i + size, n - 1)) for i in range(0, n, size)]


def cull(expr, X, Y, Z, dtype, device, batch=BATCH):
    """Host bool ``(tx, ty, tz)``, True where a batch of ``batch`` cells is
    culled: the centre's distance is beyond the batch's half diagonal (with
    a 1e-4 slack) and the 8 corners agree in sign."""
    probes, radii = [], []
    for lox, hix in _batch_slices(len(X), batch):
        for loy, hiy in _batch_slices(len(Y), batch):
            for loz, hiz in _batch_slices(len(Z), batch):
                x0, x1, y0, y1 = X[lox], X[hix], Y[loy], Y[hiy]
                z0, z1 = Z[loz], Z[hiz]
                cx, cy, cz = (x0 + x1) / 2, (y0 + y1) / 2, (z0 + z1) / 2
                radii.append(np.linalg.norm([cx - x0, cy - y0, cz - z0]))
                probes.append([(cx, cy, cz), (x0, y0, z0), (x0, y0, z1),
                               (x0, y1, z0), (x0, y1, z1), (x1, y0, z0),
                               (x1, y0, z1), (x1, y1, z0), (x1, y1, z1)])
    tshape = (-(-len(X) // batch), -(-len(Y) // batch), -(-len(Z) // batch))
    probes = np.array(probes, dtype=np.float64).reshape(-1, 3)
    f = field(expr, dtype, device)
    p = Points(*_upload([probes[:, i] for i in range(3)], dtype, device))
    values = torch.as_tensor(f(p)).broadcast_to(p.bshape).reshape(-1, 9)
    (thresh,) = _upload([np.array(radii) * (1 + 1e-4)], dtype, device)
    far = torch.abs(values[:, 0]) > thresh
    corners = values[:, 1:]
    same = torch.where(corners[:, 0] > 0, torch.all(corners > 0, dim=1),
                       torch.all(corners < 0, dim=1))
    return (far & same).cpu().numpy().reshape(tshape)


def tile_cover(keep, shape, batch):
    """``{"tile_samples", "tile_cells"}``: how many grid samples and cells
    the kept batches ``keep`` (host bool, one a batch of ``batch`` cells a
    side) cover together, on a grid of ``shape`` samples; a sample on the
    face between two kept batches counts once."""
    k = torch.as_tensor(np.asarray(keep))
    idx = []
    cells = []
    for n, t in zip(shape, k.shape):
        s = torch.arange(n)
        first = torch.clamp(s // batch, max=t - 1)
        # a sample on a batch's lower face also belongs to the batch below
        below = torch.where((s % batch == 0) & (s > 0), s // batch - 1,
                            first)
        idx.append((first, below))
        cells.append(torch.clamp((n - 1) - batch * torch.arange(t),
                                 0, batch))
    cover = torch.zeros(shape, dtype=torch.bool)
    for ix in idx[0]:
        for iy in idx[1]:
            for iz in idx[2]:
                cover |= k[ix][:, iy][:, :, iz]
    n_cells = (k * cells[0][:, None, None] * cells[1][None, :, None]
               * cells[2][None, None, :]).sum()
    return {"tile_samples": int(cover.sum()), "tile_cells": int(n_cells)}


def volume(expr, X, Y, Z, dtype, device):
    """The field at every sample, ``(nx, ny, nz)``, in blocks of x planes
    on broadcast axes."""
    Xt, Yt, Zt = _upload([X, Y, Z], dtype, device)
    f = field(expr, dtype, device)
    nx, ny, nz = len(X), len(Y), len(Z)
    vol = torch.empty((nx, ny, nz), dtype=dtype, device=device)
    step = max(1, min(nx, -(-_CHUNK_POINTS // (ny * nz))))
    for i in range(0, nx, step):
        xs = Xt[i: i + step]
        p = Points(xs[:, None, None], Yt[None, :, None], Zt[None, None, :])
        vol[i: i + step] = torch.as_tensor(f(p)).broadcast_to(
            (len(xs), ny, nz))
    return vol


def extended_codes(case, c):
    """Lewiner's extended code of cells with 8-bit ``case`` and corner
    values ``c`` (8 tensors): ``OFFSET[case] + sum of the joined faces'
    WEIGHT + s1 + 3 s2``."""
    t = tables()
    dev = case.device
    offset = torch.as_tensor(t["offset"], device=dev)
    weight = torch.as_tensor(t["weight"], device=dev)
    cl = case.long()
    ext = offset[cl]
    for f, (i0, i1, i2, i3) in enumerate(FACES):
        a, b, cc, dd = c[i0], c[i1], c[i2], c[i3]
        joined = ((a * cc - b * dd) * (a + cc - b - dd)) < 0
        ext = ext + torch.where(joined, weight[cl, f], 0)
    neg1, pos1, neg2, pos2 = interior_flags(
        c, float(torch.finfo(c[0].dtype).eps))
    s1 = torch.where(neg1, 1, torch.where(pos1, 2, 0))
    s2 = torch.where(neg2, 1, torch.where(pos2, 2, 0))
    return ext + s1 + 3 * s2


def due_edges(vol, keep, batch, origin, step, tol):
    """Sorted int64 names (``check.edge_key``'s) of the grid edges of
    ``vol`` whose ends differ in sign (``< 0`` inside) and that bound a
    kept cell, leaving out those whose crossing lies within ``tol`` steps
    of an end, reckoned from the crossing's world coordinate as ``mesh``
    rounds it (grid ``origin``, ``step``), as the check reckons it."""
    dev = vol.device
    n = vol.shape
    cells = keep.repeat_interleave(batch, 0).repeat_interleave(
        batch, 1).repeat_interleave(batch, 2)
    cells = cells[: n[0] - 1, : n[1] - 1, : n[2] - 1]
    out = []
    for a in range(3):
        v = vol.movedim(a, 0)
        kc = torch.nn.functional.pad(cells.movedim(a, 0), (1, 1, 1, 1))
        near = (kc[:, 1:, 1:] | kc[:, :-1, 1:] | kc[:, 1:, :-1]
                | kc[:, :-1, :-1])
        cross = ((v[:-1] < 0) != (v[1:] < 0)) & near
        idx = torch.nonzero(cross)  # (E, 3) in the moved order
        va = v[idx[:, 0], idx[:, 1], idx[:, 2]]
        vb = v[idx[:, 0] + 1, idx[:, 1], idx[:, 2]]
        denom = va - vb
        t = torch.clamp(torch.clamp(
            va / torch.where(denom == 0, 1.0, denom), min=0.0), max=1.0)
        u = ((idx[:, 0].to(vol.dtype) + t).to(torch.float64) * step
             + origin[a] - origin[a]) / step
        inner = (u - torch.round(u)).abs() > tol
        lower = idx[inner][:, [(d < a) + d if d != a else 0
                               for d in range(3)]]
        out.append(edge_key(lower, torch.full((len(lower),), a,
                                               device=dev)))
    return torch.sort(torch.cat(out)).values


def mesh(expr, samples, device, dtype=torch.float32, field_dtype=None,
         batch=BATCH, block_cells=2**22, nudge=0):
    """The reference mesh of ``expr`` at ``samples``.

    Returns a dict: ``soup`` (T, 3, 3) float64 world-space triangles on
    ``device`` (vertex order as emitted), ``samples`` (grid samples),
    ``cells``, ``shape`` ``(nx, ny, nz)``, ``routed`` (whether the cull
    sends the call to the tiles) and ``kept_tiles`` (batches not culled).
    ``field_dtype`` evaluates the field in another precision and rounds it
    to ``dtype`` (the control, or with ``float64`` a sound run whose
    rounding differs); ``nudge`` moves the grid's origin by that many
    float32 ulps on each axis (a bounds refinement rounding otherwise).
    ``origin`` and ``step`` give the grid; ``edges`` the grid edges due a
    vertex (``due_edges``).  ``batch``: the cull's batch of cells."""
    X, Y, Z, step = grid(expr, samples, dtype)
    if nudge:
        X, Y, Z = [a + nudge * float(np.spacing(np.float32(a[0])))
                   for a in (X, Y, Z)]
    skip = cull(expr, X, Y, Z, dtype, device, batch)
    if field_dtype is None:
        vol = volume(expr, X, Y, Z, dtype, device)
    else:
        vol = volume(expr, X, Y, Z, field_dtype, device).to(dtype)
    nx, ny, nz = vol.shape
    keep = torch.as_tensor(~skip, device=device)
    due = due_edges(vol, keep, batch, (X[0], Y[0], Z[0]), step, TOL)
    t = tables()
    ntri_t = torch.as_tensor(t["ntri"], device=device)
    tri_t = torch.as_tensor(t["tri_table"], device=device)
    edges = torch.as_tensor(EDGES, device=device)
    corner_off = torch.as_tensor(CORNERS, device=device)
    axis_of = torch.argmax(corner_off[edges[:, 1]] - corner_off[edges[:, 0]],
                           dim=1)
    origin = corner_off[edges[:, 0]]
    flat = vol.reshape(-1)
    strides = torch.tensor([ny * nz, nz, 1], device=device)
    doff = [(ox * ny + oy) * nz + oz for ox, oy, oz in CORNERS.tolist()]
    scale = torch.tensor([step, step, step], dtype=torch.float64,
                         device=device)
    shift = torch.tensor([X[0], Y[0], Z[0]], dtype=torch.float64,
                         device=device)
    parts = []
    planes = max(1, block_cells // ((ny - 1) * (nz - 1)))
    for x0 in range(0, nx - 1, planes):
        x1 = min(nx - 1, x0 + planes)
        c = [vol[x0 + ox: x1 + ox, oy: ny - 1 + oy, oz: nz - 1 + oz]
             for ox, oy, oz in CORNERS.tolist()]
        case = torch.zeros(c[0].shape, dtype=torch.int64, device=device)
        for i in range(8):
            case |= (c[i] < 0).long() << i
        ci, cj, ck = torch.nonzero((case != 0) & (case != 255),
                                   as_tuple=True)
        ci = ci + x0
        kept = keep[ci // batch, cj // batch, ck // batch]
        ci, cj, ck = ci[kept], cj[kept], ck[kept]
        base = (ci * ny + cj) * nz + ck
        corner = [flat[base + d] - 0.0 for d in doff]
        cas = torch.zeros(ci.shape, dtype=torch.int64, device=device)
        for i in range(8):
            cas |= (corner[i] < 0).long() << i
        ext = extended_codes(cas, corner)
        n = ntri_t[ext]
        cell = torch.repeat_interleave(torch.arange(len(n), device=device), n)
        first = torch.cumsum(n, 0) - n
        slot = torch.arange(len(cell), device=device) - first[cell]
        e = tri_t[ext[cell], slot]  # (T, 3) cube edges
        cx = torch.stack([ci, cj, ck], dim=1)[cell]  # (T, 3)
        lower = cx[:, None, :] + origin[e]  # (T, 3, 3) grid points
        ax = axis_of[e]  # (T, 3)
        lin = (lower * strides).sum(-1)
        va = flat[lin]
        vb = flat[lin + strides[ax]]
        denom = va - vb
        tt = torch.clamp(torch.clamp(
            va / torch.where(denom == 0, 1.0, denom), min=0.0), max=1.0)
        pos = lower.to(dtype)
        onehot = torch.nn.functional.one_hot(ax, 3).bool()
        pos = torch.where(onehot, pos + tt[..., None], pos)
        parts.append(pos.to(torch.float64) * scale + shift)
    soup = torch.cat(parts) if parts else torch.zeros(
        (0, 3, 3), dtype=torch.float64, device=device)
    cells = (nx - 1) * (ny - 1) * (nz - 1)
    return {"soup": soup, "origin": (float(X[0]), float(Y[0]), float(Z[0])),
            "step": float(step), "edges": due,
            "samples": nx * ny * nz, "cells": cells,
            "shape": (nx, ny, nz), "routed": bool(
                skip.mean() >= AUTO_TILES_THRESHOLD),
            "kept_tiles": int((~skip).sum())}



def interior_flags(c, eps):
    """``(neg1, pos1, neg2, pos2)`` interior-saddle flags of the trilinear
    interpolant of the 8 per-cell corner tensors ``c`` (CORNERS
    order, one common shape); ``eps`` is the machine epsilon of their dtype.

    ``neg1``/``pos1``: an index-1 body saddle (det H < 0) lies strictly
    inside the open cell with a negative / positive critical value;
    ``neg2``/``pos2`` likewise for the index-2 saddle.  Critical points
    solve grad f = 0: ``A z^2 + B z + C = 0`` with the stable quadratic
    formula (roots q/A and C/q), then x and y from z.  Every decision
    carries a forward error bound of GUARD_ULPS ulps so that degenerate
    cells (flat faces, boundary double roots, exact-tie critical values)
    decide identically wherever the same single IEEE operations run in the
    same order.

    The order of evaluation is fixed, every parenthesis kept: the
    lewiner table set was derived under it.  Only + - * / sqrt abs,
    comparisons and selects occur; ``2.0 * x``, ``4.0 * x`` and ``-0.5 *
    x`` are exact, and nothing is divided by a Python number.  The square
    root is correctly rounded on the CPU too; ``torch.clamp(min=0.0)``
    passes a NaN on.
    """
    c000, c100, c110, c010, c001, c101, c111, c011 = c
    k1 = c100 - c000
    k2 = c010 - c000
    k3 = c001 - c000
    k4 = c110 - c000 - k1 - k2
    k5 = c101 - c000 - k1 - k3
    k6 = c011 - c000 - k2 - k3
    k7 = c111 - c000 - k1 - k2 - k3 - k4 - k5 - k6
    g = GUARD_ULPS * eps
    ab = torch.abs

    m = k3 * k7 - k5 * k6
    sm = ab(k3 * k7) + ab(k5 * k6)
    A = k7 * m
    B = 2.0 * (k4 * m)
    C = k3 * (k4 * k4) - k4 * (k2 * k5 + k1 * k6) + k7 * (k1 * k2)
    errA = g * (ab(k7) * sm)
    errB = 2.0 * g * (ab(k4) * sm)
    errC = g * (
        ab(k3 * (k4 * k4))
        + ab(k4 * (k2 * k5))
        + ab(k4 * (k1 * k6))
        + ab(k7 * (k1 * k2))
    )
    del m, sm

    disc = B * B - 4.0 * (A * C)
    errdisc = (
        g * (B * B + 4.0 * ab(A * C))
        + 2.0 * ab(B) * errB
        + 4.0 * (ab(A) * errC + ab(C) * errA)
    )
    degen = ab(disc) <= errdisc
    has_roots = degen | (disc > 0)
    sq = torch.where(degen, 0.0, sqrt(torch.clamp(disc, min=0.0)))
    dsq = 2.0 * sq + sqrt(errdisc)
    errsq = errdisc / torch.where(dsq == 0, 1.0, dsq)
    # sign(B == +-0) -> +sq: a plain select, not copysign
    q = -0.5 * (B + torch.where(B < 0, -sq, sq))
    errq = 0.5 * (errB + errsq)
    del disc, errdisc, degen, sq, dsq, errsq, B, errB

    neg1 = torch.zeros_like(A, dtype=torch.bool)
    pos1 = torch.zeros_like(A, dtype=torch.bool)
    neg2 = torch.zeros_like(A, dtype=torch.bool)
    pos2 = torch.zeros_like(A, dtype=torch.bool)
    for num, den, errnum, errden in ((q, A, errq, errA), (C, q, errC, errq)):
        root_ok = has_roots & (ab(den) > errden)
        dsafe = torch.where(den == 0, 1.0, den)
        z = num / dsafe
        errz = (errnum + ab(z) * errden) / ab(dsafe)
        del dsafe

        dd = k4 + k7 * z
        errdd = g * (ab(k4) + ab(k7 * z)) + ab(k7) * errz
        dd_ok = ab(dd) > errdd
        ddsafe = torch.where(dd == 0, 1.0, dd)
        y = -(k1 + k5 * z) / ddsafe
        x = -(k2 + k6 * z) / ddsafe
        erry = (
            g * (ab(k1) + ab(k5 * z))
            + ab(k5) * errz
            + ab(y) * errdd
        ) / ab(ddsafe)
        errx = (
            g * (ab(k2) + ab(k6 * z))
            + ab(k6) * errz
            + ab(x) * errdd
        ) / ab(ddsafe)
        del ddsafe

        fv = (
            c000
            + k1 * x + k2 * y + k3 * z
            + k4 * (x * y) + k5 * (x * z) + k6 * (y * z)
            + k7 * ((x * y) * z)
        )
        fmag = (
            ab(c000)
            + ab(k1 * x) + ab(k2 * y) + ab(k3 * z)
            + ab(k4 * (x * y)) + ab(k5 * (x * z))
            + ab(k6 * (y * z)) + ab(k7 * ((x * y) * z))
        )
        gx = ab(k1) + ab(k4 * y) + ab(k5 * z) + ab(k7 * (y * z))
        gy = ab(k2) + ab(k4 * x) + ab(k6 * z) + ab(k7 * (x * z))
        gz = ab(k3) + ab(k5 * x) + ab(k6 * y) + ab(k7 * (x * y))
        tolfv = g * fmag + gx * errx + gy * erry + gz * errz
        del fmag, gx, gy, gz

        ok = (
            root_ok & dd_ok
            & (x > errx) & (x < 1.0 - errx)
            & (y > erry) & (y < 1.0 - erry)
            & (z > errz) & (z < 1.0 - errz)
        )
        # Saddle index: sign of det H = 2 a b c (a = dd), index-2 only when
        # the determinant clears its propagated error bound.
        bb = k5 + k7 * y
        cc = k6 + k7 * x
        errbb = g * (ab(k5) + ab(k7 * y)) + ab(k7) * erry
        errcc = g * (ab(k6) + ab(k7 * x)) + ab(k7) * errx
        det = dd * bb * cc
        errdet = (
            ab(bb * cc) * errdd
            + ab(dd * cc) * errbb
            + ab(dd * bb) * errcc
            + 2.0 * g * ab(det)
        )
        idx2 = det > errdet
        fneg = ok & (fv < -tolfv)
        fpos = ok & (fv > tolfv)
        del x, y, z, errx, erry, errz, dd, errdd, bb, cc, errbb, errcc
        del det, errdet, fv, tolfv, ok, root_ok, dd_ok
        neg1 = neg1 | (fneg & ~idx2)
        pos1 = pos1 | (fpos & ~idx2)
        neg2 = neg2 | (fneg & idx2)
        pos2 = pos2 | (fpos & idx2)
    return neg1, pos1, neg2, pos2
