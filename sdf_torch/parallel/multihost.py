"""Several processes: bring-up, the collectives of the sharded paths, and
the assembly of the triangles (counterpart of ``sdf_tpu.parallel.multihost``).

One process per rank and one device per rank.  The JAX package drives a
host's devices from one process and gives each process its own shards; here
each rank is a process that computes and reads back only its own shard:

  * ``initialize()``: one call per process, before any other use of
    ``torch.distributed`` (reads torchrun's environment);
  * z slabs (``parallel.grid``) and tile rows (``parallel.sparse``) are
    assigned per rank of a 1-D ``DeviceMesh`` whose dimension is named
    ``"grid"`` (``parallel.make_mesh``); the counts that size the buffers
    are reduced over the ranks (``all_reduce_host``, ``all_gather_host``);
  * ``gather_triangles(local)``: the ranks' soups, all gathered bit for bit,
    so that rank 0 can write the mesh (``write_on_process0``).

Counts and host arrays travel as CPU tensors, so the process group needs a
backend for the CPU: the default ``"cpu:gloo,cuda:nccl"`` has one.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

AXIS = "grid"
BACKEND = "cpu:gloo,cuda:nccl"


def initialize(backend=None, **kwargs):
    """Join the process group of a run of several processes; returns
    ``(rank, world_size)``.

    Under torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``MASTER_ADDR`` set), or with ``kwargs`` for
    ``torch.distributed.init_process_group`` (``init_method``, ``rank``,
    ``world_size``, ...), it joins the group, and a failure to do so
    raises.  Without either it is a single process: ``(0, 1)``, nothing
    started.  With a card, each rank takes card ``LOCAL_RANK % count`` as
    its current device, so ``device=None`` is its own card.  ``backend``
    defaults to ``"cpu:gloo,cuda:nccl"``; ranks that share one card pass
    ``backend="gloo"`` (NCCL refuses two ranks on one device)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR") if k in os.environ]
    if not kwargs and not env:
        return 0, 1
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", kwargs.get("rank", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend or BACKEND, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def coords(mesh, axis_name=AXIS):
    """``(rank, ranks, group)`` of this process on ``mesh``'s axis; ``(0,
    1, None)`` for no mesh."""
    if mesh is None:
        return 0, 1, None
    return (mesh.get_local_rank(axis_name), mesh.size(),
            mesh.get_group(axis_name))


def all_reduce_host(a, op, group):
    """``a`` (a numpy array) reduced over ``group`` with ``op`` ("sum" or
    "max"), as a numpy array; ``a`` itself with no group."""
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if group is not None:
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=group)
    return t.numpy()


def all_gather_host(a, group):
    """Every rank's ``a`` (numpy arrays of one shape and dtype), stacked in
    rank order: ``(ranks,) + a.shape``."""
    t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if group is None:
        return t.numpy()[None]
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out).numpy()


def _group(mesh):
    if mesh is not None:
        return coords(mesh)[2]
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def gather_triangles(local_points, mesh=None):
    """All-gather the ranks' triangle soups -> the whole ``(3T, 3)`` float64
    soup, rank-major, on every rank.

    ``local_points``: this rank's ``(3t_i, 3)`` float64 vertex soup; ranks
    may hold different counts.  The counts are gathered first, then the
    rows padded to the largest count, then trimmed: float64 travels as it
    is, so the gathered soup is bit-exact.  Over ``mesh``'s ranks, or every
    rank when None; a single process returns its own soup."""
    local = np.ascontiguousarray(local_points, dtype=np.float64).reshape(-1, 3)
    group = _group(mesh)
    if group is None:
        return local
    counts = all_gather_host(np.asarray([len(local)], np.int64), group)[:, 0]
    rows = np.zeros((int(counts.max()), 3), np.float64)
    rows[: len(local)] = local
    gathered = all_gather_host(rows, group)
    return np.concatenate([g[:n] for g, n in zip(gathered, counts)], axis=0)


def write_on_process0(path, points, mesh=None):
    """Write the gathered mesh from rank 0 (of ``mesh``, or of the world)
    only, then wait until every rank gets here."""
    from ..io import meshfmt, stl

    group = _group(mesh)
    if group is None or dist.get_rank(group) == 0:
        if path.lower().endswith(".stl"):
            stl.write_binary_stl(path, points)
        else:
            meshfmt.write_mesh(path, points)
    if group is not None:
        # A barrier on the CPU backend: an all-reduce that every rank joins.
        all_reduce_host(np.zeros(1, np.int64), "sum", group)
