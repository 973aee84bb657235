"""Differentiable shape fitting: gradient steps on SDF parameters
(counterpart of ``sdf_tpu.models.fit``).

This is the package's training step.  An SDF expression's numeric leaves
are its shape parameters (radii, transforms, blend radii; see
``core.node``).  With every leaf a tensor that requires a gradient,
``torch.autograd.grad`` differentiates the whole CSG tree, and a fit step
is plain SGD on the expression itself: the update maps over the leaves
under ``torch.no_grad()``.

The sharded forms (``make_sharded_fit_step``, ``mesh=``) wait for the
multi-device port (ROADMAP.md A14) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import diffmesh
from ..core.engine import resolve_dtype
from ..core.node import (_Node, cast, resolve_device, tree_leaves, tree_map,
                         upload)
from ..ops.vecmath import sqrt

AXIS = "grid"


def _no_mesh(mesh, what):
    if mesh is not None:
        raise NotImplementedError(
            "%s with mesh= is not ported yet (ROADMAP A14)" % what)


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
    """A fit step sharding the point batch over several devices: not ported
    yet (ROADMAP.md A14)."""
    raise NotImplementedError(
        "make_sharded_fit_step is not ported yet (ROADMAP A14)")


def make_chamfer_loss(bounds, resolution=24, capacity=None,
                      dtype=torch.float32, mesh=None):
    """Symmetric chamfer distance between a target point cloud and the
    EXTRACTED surface (not an SDF oracle): gradients flow through marching
    cubes (``core.diffmesh``) into the shape parameters.  The loss runs on
    the device of the target points it is given."""
    _no_mesh(mesh, "make_chamfer_loss")
    if capacity is None:
        # Roomier than extract's default: a truncated surface during
        # fitting corrupts gradients (extract warns, but the optimizer
        # would still wander).
        r = resolution if np.isscalar(resolution) else max(resolution)
        capacity = 8 * r * r

    def loss(node, targets):
        verts, _, valid = diffmesh.extract(
            node, bounds, resolution, capacity, dtype, device=targets.device
        )
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
    the extracted surface.  Returns ``(fitted_node, final_loss)``."""
    _no_mesh(mesh, "fit_chamfer")
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    node = _params(builder, dtype, device)
    t, lr = upload([np.asarray(target_points), np.asarray(lr)], dtype, device)
    loss_fn = make_chamfer_loss(bounds, resolution, capacity, dtype)
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
    ``points``.  Returns ``(fitted_node, final_loss)``."""
    _no_mesh(mesh, "fit")
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    points = np.asarray(points)
    if isinstance(target_sdf, _Node):
        target = target_sdf(points, device=device)
    else:
        target = target_sdf(points)
    t = torch.as_tensor(target, device=device).to(dtype).reshape(-1)
    p, lr = upload([points, np.asarray(lr)], dtype, device)
    node = builder
    loss = None
    for i in range(steps):
        node, loss = fit_step(node, p, t, lr)
        if verbose and (i % max(1, steps // 10) == 0):
            print(f"step {i}: loss {float(loss):.3e}")
    return node, float(loss)
