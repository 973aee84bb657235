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

from . import mc
from .engine import resolve_dtype
from .node import Points, cast, resolve_device, upload


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


def extract_sharded(node, bounds, resolution=64, capacity=None,
                    dtype=torch.float32, mesh=None, axis_name="grid",
                    variant="lewiner", device=None):
    """Differentiable extraction sharded over several devices: not ported
    yet (ROADMAP.md A14)."""
    raise NotImplementedError(
        "diffmesh.extract_sharded is not ported yet (ROADMAP A14)")


def mean_vertex(node, bounds, resolution=64, capacity=None,
                dtype=torch.float32, variant="lewiner", device=None):
    """Mass centre of the extracted surface (a simple differentiable
    probe): the mean of the kept triangles' vertices, a (3,) tensor."""
    verts, _, valid = extract(node, bounds, resolution, capacity, dtype,
                              variant, device)
    w = valid.to(verts.dtype)[:, None, None]
    kept = valid.sum()  # n can exceed capacity under overflow
    return (verts * w).sum(dim=(0, 1)) / torch.clamp(3.0 * kept, min=1.0)
