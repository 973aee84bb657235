"""Triangle-mesh import and mesh -> SDF conversion (counterpart of
``sdf_tpu.ops.meshsdf``).

``Mesh.sdf`` samples a signed distance grid around the mesh with torch ops
on the run's device:

  * unsigned distance: exact point-triangle distance (Ericson's algorithm),
    min-reduced over all triangles, chunked over points and triangles as the
    JAX package does;
  * sign: the generalized winding number (the sum of signed solid angles),
    robust for imperfectly closed meshes;
  * the band is clamped to +/- background as in an OpenVDB narrow-band
    level set, and queries outside the grid return ``background``.

In the JAX package this is plain jitted XLA, not a Pallas kernel, so torch
ops on the card are its port.  float32 throughout, as there.

The resulting SDF gates a trilinear grid lookup by a cheap bounding-box
estimator and exposes the grid as attributes of its eval function
(``f.array``, ``f.xyz``, ``f.background``, ``f.estimator``).  The lookup has
no statement form in the generated kernel body: the eval function is
gather-marked (``core.hybrid``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import hybrid
from ..core.node import as_param, resolve_device
from . import vecmath as vm
from .shapes3 import box, sdf3


def _sum3(a, b):
    """The dot product of the last axes (length 3), as three terms."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _where3(c, a, b):
    return torch.where(c[..., None], a, b)


def _tri_block(q, a, b, c, best2, winding):
    """One triangle chunk against one point chunk: the running minimum
    squared distance and winding sum, updated.  ``q`` is (n, 1, 3), the
    triangle corners (1, tc, 3)."""
    # Exact point-triangle distance (Ericson, Real-Time Collision Detection
    # 5.1.5), over all (point, triangle) pairs.
    ab = b - a
    ac = c - a
    ap = q - a
    d1 = _sum3(ab, ap)
    d2 = _sum3(ac, ap)
    bp = q - b
    d3 = _sum3(ab, bp)
    d4 = _sum3(ac, bp)
    cp = q - c
    d5 = _sum3(ab, cp)
    d6 = _sum3(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    eps = 1e-30

    def safe_div(num, den):
        return num / torch.where(vm._abs(den) < eps, eps, den)

    # Region tests, resolved with nested where.
    v_ab = torch.clamp(safe_div(d1, d1 - d3), 0.0, 1.0)
    v_ac = torch.clamp(safe_div(d2, d2 - d6), 0.0, 1.0)
    v_bc = torch.clamp(safe_div(d4 - d3, (d4 - d3) + (d5 - d6)), 0.0, 1.0)

    denom = safe_div(torch.ones_like(va), va + vb + vc)
    v = vb * denom
    w = vc * denom

    closest = a + ab * v[..., None] + ac * w[..., None]
    closest = _where3((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
                      b + (c - b) * v_bc[..., None], closest)
    closest = _where3((vb <= 0) & (d2 >= 0) & (d6 <= 0),
                      a + ac * v_ac[..., None], closest)
    closest = _where3((vc <= 0) & (d1 >= 0) & (d3 <= 0),
                      a + ab * v_ab[..., None], closest)
    closest = _where3((d6 >= 0) & (d5 <= d6), c.expand_as(closest), closest)
    closest = _where3((d3 >= 0) & (d4 <= d3), b.expand_as(closest), closest)
    closest = _where3((d1 <= 0) & (d2 <= 0), a.expand_as(closest), closest)

    r = q - closest
    best2 = torch.minimum(best2, torch.amin(_sum3(r, r), dim=1))

    # Sign: the generalized winding number (sum of solid angles).
    ra = a - q
    rb = b - q
    rc = c - q
    la = vm.sqrt(_sum3(ra, ra))
    lb = vm.sqrt(_sum3(rb, rb))
    lc = vm.sqrt(_sum3(rc, rc))
    det = _sum3(ra, _cross(rb, rc))
    dd = la * lb * lc + _sum3(ra, rb) * lc + _sum3(rb, rc) * la \
        + _sum3(rc, ra) * lb
    omega = 2.0 * torch.atan2(det, dd)
    return best2, winding + omega.sum(dim=1)


def _mesh_distance_field(points, tri_a, tri_b, tri_c, chunks, tchunks=1):
    """Signed distances from query points to a triangle soup.

    points: (N, 3) query points (N divisible by ``chunks``); tri_a/b/c:
    (T, 3) triangle corners (T divisible by ``tchunks``; pad with
    degenerate far-away triangles, whose zero area adds no winding).  All
    float32 tensors on one device.  Returns (N,) signed distances,
    negative inside by the winding number.  Both axes are chunked, so the
    pairwise work set is (N / chunks) x (T / tchunks)."""
    corners = [t.reshape(tchunks, -1, 3) for t in (tri_a, tri_b, tri_c)]
    out = []
    for p in points.reshape(chunks, -1, 3):
        n = p.shape[0]
        best2 = torch.full((n,), math.inf, dtype=p.dtype, device=p.device)
        winding = torch.zeros((n,), dtype=p.dtype, device=p.device)
        q = p[:, None, :]
        for k in range(tchunks):
            a, b, c = (t[k][None, :, :] for t in corners)
            best2, winding = _tri_block(q, a, b, c, best2, winding)
        dist = vm.sqrt(best2)
        out.append(torch.where(winding / (4.0 * math.pi) > 0.5, -dist, dist))
    return torch.cat(out)


class Mesh:
    """A triangle mesh with affine positioning helpers."""

    @classmethod
    def from_file(cls, path):
        from ..io import meshfmt

        points, triangles = meshfmt.read_mesh(path)
        return cls(points, triangles)

    def __init__(self, points, triangles):
        self.points = np.asarray(points, dtype=np.float64)
        self.triangles = np.asarray(triangles, dtype=np.int64)

    @property
    def size(self):
        a = self.points.min(axis=0)
        b = self.points.max(axis=0)
        return tuple((b - a).tolist())

    @property
    def bounding_box(self):
        a = tuple(self.points.min(axis=0).tolist())
        b = tuple(self.points.max(axis=0).tolist())
        return (a, b)

    def transformed(self, matrix):
        points = np.hstack([self.points, np.ones((self.points.shape[0], 1))])
        points = points @ np.array(matrix).T
        return Mesh(points[:, :3], self.triangles)

    def scaled(self, scale):
        try:
            sx, sy, sz = scale
        except TypeError:
            sx = sy = sz = scale
        matrix = [[sx, 0, 0, 0], [0, sy, 0, 0], [0, 0, sz, 0], [0, 0, 0, 1]]
        return self.transformed(matrix)

    def translated(self, offset):
        dx, dy, dz = offset
        matrix = [[1, 0, 0, dx], [0, 1, 0, dy], [0, 0, 1, dz], [0, 0, 0, 1]]
        return self.transformed(matrix)

    def positioned(self, position, anchor):
        a, b = map(np.array, self.bounding_box)
        p = a + (b - a) * anchor
        return self.translated(np.asarray(position) - p)

    def centered(self):
        return self.positioned((0, 0, 0), (0.5, 0.5, 0.5))

    @sdf3
    def sdf(self, voxel_size, half_width=None, chunk_points=2**15,
            device=None):
        """The mesh's SDF, sampled at ``voxel_size`` on ``device`` (None
        means the card, as at every entry point; ``"cpu"`` runs there)."""
        device = resolve_device(device)
        a, b = self.bounding_box
        estimator = box(a=a, b=b)

        half_width_voxels = 3
        if half_width is not None:
            half_width_voxels = max(
                half_width_voxels, int(np.ceil(half_width / voxel_size))
            )
        background = half_width_voxels * voxel_size

        # Dense sample grid covering the mesh plus the narrow band.
        lo = np.floor((np.array(a) - background) / voxel_size).astype(int)
        hi = np.ceil((np.array(b) + background) / voxel_size).astype(int)
        size = hi - lo + 1
        X = (lo[0] + np.arange(size[0])) * voxel_size
        Y = (lo[1] + np.arange(size[1])) * voxel_size
        Z = (lo[2] + np.arange(size[2])) * voxel_size
        P = np.stack(np.meshgrid(X, Y, Z, indexing="ij"), axis=-1).reshape(-1, 3)

        n = len(P)
        chunks = max(1, -(-n // chunk_points))
        pad = chunks * chunk_points - n if chunks > 1 else 0
        if pad:
            P = np.concatenate([P, np.zeros((pad, 3))])
            chunks = len(P) // chunk_points

        tris = self.points[self.triangles]  # (T, 3, 3)
        # Triangle-axis chunks bound the pairwise working set (~2^25 pairs);
        # padding triangles are degenerate and far away.
        T = len(tris)
        tchunk = max(1, min(T, (1 << 25) // max(1, chunk_points)))
        tchunks = -(-T // tchunk)
        padT = tchunks * tchunk - T
        if padT:
            far = np.full((padT, 3, 3), 1e9, dtype=tris.dtype)
            tris = np.concatenate([tris, far])
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
        dist = _mesh_distance_field(f32(P), f32(tris[:, 0]), f32(tris[:, 1]),
                                    f32(tris[:, 2]), chunks, tchunks)
        A = dist.cpu().numpy()[:n].reshape(tuple(size))
        A = np.clip(A, -background, background)  # the narrow-band clamp

        origin = np.array([X[0], Y[0], Z[0]])
        params = {
            "grid": as_param(A),
            "origin": as_param(origin),
            "voxel": as_param(voxel_size),
            "background": as_param(background),
            "estimator": estimator,
        }

        @hybrid.mark_gather
        def fn(q, p):
            # A cheap box gate, then the trilinear fetch.
            e = q["estimator"](p)
            d = _trilinear(q["grid"], (p - q["origin"]) / q["voxel"],
                           q["background"])
            return torch.where(e > q["background"], e, d)

        # The attributes a mesh SDF exposes (SDF3 falls through to them).
        fn.array = A
        fn.xyz = (X, Y, Z)
        fn.background = background
        fn.estimator = estimator
        return fn, params


def _trilinear(grid, idx, fill):
    """Trilinear interpolation of ``grid`` at the fractional indices
    ``idx`` (Points); out-of-bounds queries return ``fill``."""
    nx, ny, nz = grid.shape
    ix, iy, iz = idx.c
    inside = (
        (ix >= 0)
        & (ix <= nx - 1)
        & (iy >= 0)
        & (iy <= ny - 1)
        & (iz >= 0)
        & (iz <= nz - 1)
    )

    def corner(i, n):
        return torch.clamp(torch.floor(i).to(torch.int64), 0, n - 2)

    x0, y0, z0 = corner(ix, nx), corner(iy, ny), corner(iz, nz)
    fx = ix - x0.to(ix.dtype)
    fy = iy - y0.to(iy.dtype)
    fz = iz - z0.to(iz.dtype)

    def g(dx, dy, dz):
        return grid[x0 + dx, y0 + dy, z0 + dz]

    c00 = g(0, 0, 0) * (1 - fx) + g(1, 0, 0) * fx
    c10 = g(0, 1, 0) * (1 - fx) + g(1, 1, 0) * fx
    c01 = g(0, 0, 1) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(0, 1, 1) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    val = c0 * (1 - fz) + c1 * fz
    return torch.where(inside, val, fill)
