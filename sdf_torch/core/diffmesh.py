"""Differentiable surface extraction: gradients through marching cubes
(counterpart of ``sdf_tpu.core.diffmesh``).

The chain

    shape params -> grid values -> edge-interpolated vertex positions

is torch ops from the parameters to the vertices: the node evaluates on the
grid with torch ops (not kernel B1, which takes no gradient), and
``mc.emit``'s vertices are a gather and a lerp of grid values, so
``torch.autograd.grad`` differentiates triangle vertices with respect to
every leaf tensor of the expression that requires a gradient (radii,
transforms, blend k).  The discrete parts -- case codes (kernel B2 under
lewiner), triangle counts (B3), the compacted cells (B4) -- are integers
computed from the detached volume and act as constants under
differentiation: the fixed-topology treatment of differentiable marching
cubes, as in the JAX package.

Typical use: a mesh-space loss (chamfer to a scan, area, silhouette)
optimized over CSG parameters with ``extract`` and ``torch.autograd.grad``
(``models.fit.fit_chamfer``).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist

from . import mc
from .engine import resolve_dtype
from .node import Points, cast, resolve_device, tree_map, upload
from .node import fetch as node_fetch


def _resolve(bounds, resolution, capacity, dtype, device):
    """Grid shape, capacity (default ``4 * r^2``), and the origin and step
    as ``dtype`` tensors on ``device``."""
    try:
        rx, ry, rz = resolution
    except TypeError:
        rx = ry = rz = resolution
    (x0, y0, z0), (x1, y1, z1) = bounds
    if capacity is None:
        capacity = 4 * max(rx, ry, rz) ** 2
    origin, step = upload(
        [np.asarray([x0, y0, z0], np.float64),
         np.asarray([(x1 - x0) / (rx - 1), (y1 - y0) / (ry - 1),
                     (z1 - z0) / (rz - 1)], np.float64)],
        dtype, device)
    return (rx, ry, rz), capacity, origin, step


def extract(node, bounds, resolution=64, capacity=None, dtype=torch.float32,
            variant="lewiner", device=None):
    """Differentiable triangle extraction on a fixed grid.

    node: an SDF expression; leaves that are tensors requiring a gradient
    keep it (``cast`` leaves a tensor of the right dtype and device as it
    is).  bounds: ((x0,y0,z0),(x1,y1,z1)).  resolution: samples per axis
    (int or 3-tuple).  capacity: triangle buffer size (default ``4 *
    resolution^2``).  variant: "lewiner" (the default, kernel B2's
    extended codes) or "fast", as ``generate(mc_variant=)``.  device: the
    card when None.

    Returns (verts, n, valid): verts (capacity, 3, 3) world-space triangle
    vertices, differentiable with respect to the node's leaves; rows where
    ``valid`` is False are padding to mask out of any loss.  ``n`` is the
    TRUE triangle total (a 0-d tensor): overflow shows as ``n >
    capacity``, only ``capacity`` triangles are kept, and a warning is
    issued (one host read of the total).
    """
    variant = mc.get_tables(variant).name  # "fast" -> "default"
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    (rx, ry, rz), capacity, origin, step = _resolve(
        bounds, resolution, capacity, dtype, device)
    # World coordinates from unit index grids, origin + step * i, as the
    # JAX package forms them (its origin and step are traced inputs).
    X, Y, Z = (origin[a] + step[a] * torch.arange(r, dtype=dtype,
                                                 device=device)
               for a, r in enumerate((rx, ry, rz)))
    p = Points(X[:, None, None], Y[None, :, None], Z[None, None, :])
    vol = torch.as_tensor(cast(node, dtype, device)(p))
    vol = vol.broadcast_to((rx, ry, rz)).contiguous()
    keep = torch.ones((rx - 1, ry - 1, rz - 1), dtype=torch.bool,
                      device=device)
    # The true total, independent of the buffers: a fitting loss that saw a
    # truncated surface would get a silently wrong gradient.
    case = mc._classify(vol, variant)
    total = mc.ntri_of(case, variant).sum()
    verts9, n = mc.emit(vol, keep, capacity, case=case, variant=variant)
    kept = torch.clamp(torch.minimum(n, total), max=capacity)
    n_true = int(total)  # the call's one host read
    if n_true > capacity:
        warnings.warn(
            "diffmesh.extract: surface has %d triangles but capacity=%d; "
            "extra triangles were dropped -- raise capacity=" % (n_true,
                                                                 capacity)
        )
    world9 = verts9 * step.repeat(3)[:, None] + origin.repeat(3)[:, None]
    world = world9.T.reshape(capacity, 3, 3)
    valid = torch.arange(capacity, device=device) < kept
    return world, total, valid


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the incoming gradient over the
    ranks of ``group``: a leaf used by every rank gets the gradient of the
    whole computation (JAX's transpose ``psum`` of a replicated input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _all_gather(x, group):
    """Every rank's ``x`` concatenated along dim 0 in rank order, on
    ``x``'s device."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return torch.cat(out)


class _Gather(torch.autograd.Function):
    """All-gather along dim 0 over ``group``, in rank order.  Its backward
    returns this rank's rows of the incoming gradient, and no sum: every
    rank computes the same loss from the gathered rows, so a sum would
    count each rank's share once a rank."""

    @staticmethod
    def forward(ctx, x, rank, group):
        ctx.rank, ctx.n = rank, x.shape[0]
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.n: (ctx.rank + 1) * ctx.n], None, None


def extract_sharded(node, bounds, resolution=64, capacity=None,
                    dtype=torch.float32, mesh=None, axis_name="grid",
                    variant="lewiner", device=None):
    """Differentiable extraction sharded over the ranks of a ``DeviceMesh``
    (counterpart of sdf_tpu.core.diffmesh.extract_sharded).

    The grid's z cells are cut into one slab a rank, with the recomputed
    1-sample halo of ``parallel.grid``; each rank meshes its slab into a
    buffer of the FULL ``capacity`` (slab counts are far from even: an
    equatorial slab of a sphere holds many times a polar one) and adds the
    slab offset to the integer z before the interpolation, so its vertices
    equal ``extract``'s bit for bit.  ``mesh`` None is every rank
    (``parallel.make_mesh`` on ``device``'s type).

    Returns ``(verts, n, valid)`` on every rank, as ``extract`` does but
    global: ``verts (ranks * capacity, 3, 3)`` world-space triangles,
    rank-major, gathered from every rank; ``n`` the true global total (a
    0-d tensor; overflow shows as a rank's rows all valid and ``n`` above
    what is kept, with a warning: the forward's one host read).  A loss of
    the same value on every rank, differentiated with
    ``torch.autograd.grad`` on each, gives each rank the gradient of the
    whole surface: the gathered rows send back only this rank's share, and
    the expression's leaves sum their gradients over the ranks."""
    from ..parallel.grid import make_mesh
    from ..parallel.multihost import coords

    variant = mc.get_tables(variant).name
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    if mesh is None:
        mesh = make_mesh(device.type, axis_name)
    rank, ndev, group = coords(mesh, axis_name)
    (rx, ry, rz), cap_d, origin, step = _resolve(
        bounds, resolution, capacity, dtype, device)
    c = -(-(rz - 1) // ndev)  # z cells a rank
    zidx = np.minimum(rank * c + np.arange(c + 1), rz - 1)
    X, Y = (origin[a] + step[a] * torch.arange(r, dtype=dtype, device=device)
            for a, r in enumerate((rx, ry)))
    (zi,) = upload([zidx], dtype, device)
    Z = origin[2] + step[2] * zi
    node = tree_map(
        lambda w: (_SumGrad.apply(w, group)
                   if isinstance(w, torch.Tensor) and w.requires_grad else w),
        cast(node, dtype, device))
    p = Points(X[:, None, None], Y[None, :, None], Z[None, None, :])
    vol = torch.as_tensor(node(p)).broadcast_to((rx, ry, c + 1)).contiguous()
    (zok,) = upload([rank * c + np.arange(c) < rz - 1], torch.bool, device)
    keep = zok.expand(rx - 1, ry - 1, c)  # padded cells past the grid off
    case = mc._classify(vol, variant)
    total = (mc.ntri_of(case, variant) * keep.to(torch.int32)).sum()
    verts9, nn = mc.emit(vol, keep, cap_d, case=case, variant=variant,
                         z_offset=rank * c)
    kept = torch.clamp(torch.minimum(nn, total), max=cap_d)
    world9 = verts9 * step.repeat(3)[:, None] + origin.repeat(3)[:, None]
    world = _Gather.apply(world9.T.reshape(cap_d, 3, 3), rank, group)
    counts = _all_gather(torch.stack([kept, total]).to(torch.int64)[None],
                         group)  # (ranks, 2): kept, true total
    gtotal = counts[:, 1].sum()
    per_rank = node_fetch([counts])[0]  # the call's one host read
    if (per_rank[:, 1] > cap_d).any():
        warnings.warn(
            "diffmesh.extract_sharded: a slab has %d triangles but "
            "capacity=%d a rank; extra triangles were dropped -- raise "
            "capacity=" % (per_rank[:, 1].max(), cap_d))
    valid = (torch.arange(cap_d, device=device)[None, :]
             < counts[:, :1]).reshape(-1)
    return world, gtotal, valid


def mean_vertex(node, bounds, resolution=64, capacity=None,
                dtype=torch.float32, variant="lewiner", device=None):
    """Mass centre of the extracted surface (a simple differentiable
    probe): the mean of the kept triangles' vertices, a (3,) tensor."""
    verts, _, valid = extract(node, bounds, resolution, capacity, dtype,
                              variant, device)
    w = valid.to(verts.dtype)[:, None, None]
    kept = valid.sum()  # n can exceed capacity under overflow
    return (verts * w).sum(dim=(0, 1)) / torch.clamp(3.0 * kept, min=1.0)
