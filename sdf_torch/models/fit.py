"""Differentiable shape fitting: gradient steps on SDF parameters
(counterpart of ``sdf_tpu.models.fit``).

This is the package's training step.  An SDF expression's numeric leaves
are its shape parameters (radii, transforms, blend radii; see
``core.node``).  With every leaf a tensor that requires a gradient,
``torch.autograd.grad`` differentiates the whole CSG tree, and a fit step
is plain SGD on the expression itself: the update maps over the leaves
under ``torch.no_grad()``.

The sharded forms split the work over the ranks of a ``DeviceMesh``
(``parallel.make_mesh``): ``make_sharded_fit_step`` gives each rank its
slice of the point batch and all-reduces the loss and the gradients, so
every rank applies the same update (synchronous data parallelism);
``mesh=`` on ``make_chamfer_loss`` and ``fit_chamfer`` extracts the surface
with ``diffmesh.extract_sharded``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core import diffmesh
from ..core.engine import resolve_dtype
from ..core.node import (_Node, cast, resolve_device, tree_leaves, tree_map,
                         upload)
from ..ops.vecmath import sqrt

AXIS = "grid"


def _params(node, dtype, device):
    """A copy of ``node`` whose leaves are new leaf tensors of ``dtype`` on
    ``device`` that require a gradient (the caller's tensors untouched)."""
    return tree_map(lambda w: w.detach().requires_grad_(True),
                    cast(node, dtype, device))


def _step(loss_fn, node, args, lr):
    """One SGD step of ``loss_fn(node, *args)`` over ``node``'s leaves:
    ``(new_node, loss)``.  A leaf the loss does not reach gets a zero
    gradient, as in JAX."""
    leaves = tree_leaves(node)
    with torch.enable_grad():
        loss = loss_fn(node, *args)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def update(w):
        g = next(grads)
        new = w.detach() if g is None else w - lr * g
        return new.requires_grad_(True)

    with torch.no_grad():
        return tree_map(update, node), loss.detach()


def _loss(node, points, target):
    d = node(points)[:, 0]
    return torch.mean((d - target) ** 2)


def fit_step(node, points, target, lr):
    """One SGD step on an SDF expression's parameters.

    node: an SDF expression (its leaves are cast to the points' dtype and
    device).  points: (N, dim) tensor of sample points; target: (N,)
    target distances; lr: a number or a 0-d tensor.  Returns ``(new_node,
    loss)``; the new node's leaves are leaf tensors that require a
    gradient."""
    node = _params(node, points.dtype, points.device)
    return _step(_loss, node, (points, target), lr)


def make_sharded_fit_step(mesh, axis_name=AXIS):
    """A fit step that shards the point batch over ``mesh``'s ranks.

    The returned ``step(node, points, target, lr)`` takes the whole batch
    on every rank and keeps its own contiguous slice, in rank order.  The
    local loss is normalised by the GLOBAL point count; one all-reduce
    (sum) over the ranks makes the loss and the gradients those of the
    whole batch, and every rank applies the same SGD update.  Returns
    ``(new_node, loss)`` as ``fit_step`` does.  A batch that does not divide
    over the ranks raises ``ValueError``."""
    from ..parallel.multihost import coords

    rank, ndev, group = coords(mesh, axis_name)

    def step(node, points, target, lr):
        n = points.shape[0]
        if n % ndev:
            raise ValueError(
                "point batch of %d does not divide over the %d-rank mesh; "
                "pad or trim to a multiple of %d" % (n, ndev, ndev))
        part = slice(rank * (n // ndev), (rank + 1) * (n // ndev))
        node = _params(node, points.dtype, points.device)
        leaves = tree_leaves(node)
        with torch.enable_grad():
            d = node(points[part])[:, 0]
            loss = torch.sum((d - target[part]) ** 2) / n
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # One all-reduce carries the loss and every gradient.
        parts = [loss.detach().reshape(1)] + [
            torch.zeros_like(w).reshape(-1) if g is None else g.reshape(-1)
            for w, g in zip(leaves, grads)]
        flat = torch.cat(parts)
        dist.all_reduce(flat, group=group)
        sizes = [p.numel() for p in parts]
        loss, *grads = torch.split(flat, sizes)
        grads = iter(g.view_as(w) for g, w in zip(grads, leaves))
        with torch.no_grad():
            new = tree_map(lambda w: (w - lr * next(grads)).requires_grad_(True),
                           node)
        return new, loss.reshape(())

    return step


def make_chamfer_loss(bounds, resolution=24, capacity=None,
                      dtype=torch.float32, mesh=None):
    """Symmetric chamfer distance between a target point cloud and the
    EXTRACTED surface (not an SDF oracle): gradients flow through marching
    cubes (``core.diffmesh``) into the shape parameters.  The loss runs on
    the device of the target points it is given.  With ``mesh=`` the
    extraction is sharded (``diffmesh.extract_sharded``)."""
    if capacity is None:
        # Roomier than extract's default: a truncated surface during
        # fitting corrupts gradients (extract warns, but the optimizer
        # would still wander).
        r = resolution if np.isscalar(resolution) else max(resolution)
        capacity = 8 * r * r

    def loss(node, targets):
        if mesh is None:
            verts, _, valid = diffmesh.extract(
                node, bounds, resolution, capacity, dtype,
                device=targets.device)
        else:
            verts, _, valid = diffmesh.extract_sharded(
                node, bounds, resolution, capacity, dtype, mesh=mesh,
                device=targets.device)
        v = verts.reshape(-1, 3)
        vmask = valid[:, None].expand(-1, 3).reshape(-1)
        eps = 1e-12
        d2 = torch.sum((targets[:, None, :] - v[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(vmask[None, :], d2, 1e9)
        # amin splits the gradient of a tie evenly, as jnp.min's does (a
        # soup repeats each vertex in several triangles).
        cloud_to_mesh = torch.mean(sqrt(torch.amin(d2, dim=1) + eps))
        dv = sqrt(torch.amin(d2, dim=0) + eps)
        mesh_to_cloud = torch.sum(torch.where(vmask, dv, 0)) / torch.clamp(
            torch.sum(vmask), min=1)
        return cloud_to_mesh + mesh_to_cloud

    return loss


def fit_chamfer(builder, target_points, bounds, steps=60, lr=5e-2,
                resolution=24, capacity=None, dtype=torch.float32, mesh=None,
                verbose=False, device=None):
    """Fit an SDF expression to a target POINT CLOUD by chamfer distance on
    the extracted surface (sharded over ``mesh``'s ranks when given).
    Returns ``(fitted_node, final_loss)``."""
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    node = _params(builder, dtype, device)
    t, lr = upload([np.asarray(target_points), np.asarray(lr)], dtype, device)
    loss_fn = make_chamfer_loss(bounds, resolution, capacity, dtype, mesh)
    loss = None
    for i in range(steps):
        node, loss = _step(loss_fn, node, (t,), lr)
        if verbose and (i % max(1, steps // 10) == 0):
            print(f"step {i}: chamfer {float(loss):.3e}")
    return node, float(loss)


def fit(builder, target_sdf, points, steps=100, lr=1e-2, dtype=torch.float32,
        mesh=None, verbose=False, device=None):
    """Fit a parametric model to a target SDF on fixed sample points.

    builder: an SDF expression (the initial model).  target_sdf: an SDF
    expression, or a callable giving target distances at the (N, 3) numpy
    ``points``.  With ``mesh=`` the batch is trimmed to a multiple of the
    mesh's ranks and sharded over them (``make_sharded_fit_step``).
    Returns ``(fitted_node, final_loss)``."""
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    points = np.asarray(points)
    step = fit_step
    if mesh is not None:
        points = points[: len(points) // mesh.size() * mesh.size()]
        step = make_sharded_fit_step(mesh)
    if isinstance(target_sdf, _Node):
        target = target_sdf(points, device=device)
    else:
        target = target_sdf(points)
    t = torch.as_tensor(target, device=device).to(dtype).reshape(-1)
    p, lr = upload([points, np.asarray(lr)], dtype, device)
    node = builder
    loss = None
    for i in range(steps):
        node, loss = step(node, p, t, lr)
        if verbose and (i % max(1, steps // 10) == 0):
            print(f"step {i}: loss {float(loss):.3e}")
    return node, float(loss)
