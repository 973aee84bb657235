"""Field inputs for subtrees the generated eval kernels cannot hold
(counterpart of ``sdf_tpu.core.hybrid``).

Some SDF nodes need gathers (a texture or mesh-grid lookup by a computed
index, a polygon's loop over its edges, a legacy closure that runs on the
host), which have no statement form in the generated per-point body of
``core.eval_classify``.  Such an eval function is tagged with
``mark_gather``.  Rather than keeping the whole expression off the
kernel, the tree is split:

  1. ``to_recording_tree``: every gather-bearing subtree is wrapped so that
     evaluating the full tree with torch ops *records* the subtree's output
     field.  The recording happens in place in the original tree, so each
     occurrence is evaluated at its true, ancestor-transformed query points
     (a lookup under ``rotate`` sees rotated coordinates), and a parent
     that evaluates its child several times (``circular_array``: two
     copies) records one field per evaluation.
  2. ``to_kernel_tree``: the same subtrees are replaced by placeholders.
     While the kernel body is generated a placeholder records as a read of
     the k-th field input at the point's own index; while the plain version
     runs it returns the k-th field tensor.  Both run inside a
     ``kernel_fields`` context that hands out the fields in order.

``route_fields`` marks nodes automatically: each node whose own function
uses an op that the kernel body has no form for (``eval_classify.NoCppForm``,
e.g. ``torch.erf`` in a user's ``@sdf3``) becomes a field in the same way,
as the reference falls back from its kernel to XLA.  ``generate`` applies
it once, and so do the mesh functions a user may call without it
(``core.sparse.mesh_sparse_tiles`` and the two of ``parallel``); the tree
``generate`` hands them passes through.

Fields and placeholder reads pair up by order: both passes run the same
tree with the same non-gather code, so child calls happen in the same
sequence.  The pre-passes are plain torch ops outside any kernel:
``record_dense_windows`` for the dense kernel B1, once over the whole grid
in the layout of B1's volume (B1 marches slabs and keeps no per-chunk
window, so the reference's overlapping z windows become one volume a
field), and ``record_tile_windows`` for the per-tile kernel B7.  PyTorch
prunes nothing, so a pre-pass evaluates the whole tree once on its
points, not only the gather subtrees.
"""

from __future__ import annotations

import contextvars
import functools
import weakref

import torch

from ..utils import checkpoint as ckpt
from .node import SDF2, Points, _Node, cast

# Side channels of one evaluation: the list that collects recorded fields,
# and the supplier of field values for placeholder nodes.
_TAPE = contextvars.ContextVar("sdf_torch_gather_tape", default=None)
_FIELDS = contextvars.ContextVar("sdf_torch_kernel_fields", default=None)


def mark_gather(fn):
    """Tag an SDF eval function as needing gathers the generated kernel
    body cannot hold."""
    fn.needs_gather = True
    return fn


def needs_gather(fn):
    return getattr(fn, "needs_gather", False)


def _child_nodes(tree):
    """The SDF nodes directly under a parameter tree, in ``tree_leaves``
    order."""
    if isinstance(tree, _Node):
        return [tree]
    if isinstance(tree, dict):
        return [n for key in sorted(tree) for n in _child_nodes(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [n for x in tree for n in _child_nodes(x)]
    return []


def count_gathers(node):
    """Number of gather-bearing subtree occurrences in an expression."""
    if not isinstance(node, _Node):
        return 0
    if needs_gather(node.fn):
        return 1
    return sum(count_gathers(c) for c in _child_nodes(node.params))


def _map_nodes(tree, f):
    """Copy of a parameter tree with every directly held SDF node replaced
    by ``f(node)``, called in ``_child_nodes`` order; other leaves are
    shared."""
    if isinstance(tree, _Node):
        return f(tree)
    if isinstance(tree, dict):
        done = {key: _map_nodes(tree[key], f) for key in sorted(tree)}
        return {key: done[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_nodes(x, f) for x in tree)
    return tree


def _rebuilt(node, fn, params):
    out = object.__new__(type(node))
    out.fn = fn
    out.params = params
    out._k = node._k
    return out


def _placeholder_fn(q, p):
    fields = _FIELDS.get()
    if fields is None:
        raise RuntimeError(
            "gather placeholder evaluated outside a kernel_fields context"
        )
    return fields.take()


def to_kernel_tree(node):
    """Copy of the expression with gather subtrees replaced by placeholders
    that read the next field input."""
    if not isinstance(node, _Node):
        return node
    if needs_gather(node.fn):
        return _rebuilt(node, _placeholder_fn, ())
    return _rebuilt(node, node.fn, _map_nodes(node.params, to_kernel_tree))


# One wrapper per eval function, so a rebuilt recording tree has the same
# structure key every time.
_REC_WRAP = {}


def _rec_wrapper(fn):
    if fn not in _REC_WRAP:
        if len(_REC_WRAP) > 256:
            _REC_WRAP.clear()

        def rec(q, p, _fn=fn):
            d = _fn(q, p)
            _TAPE.get().append(d)
            return d

        _REC_WRAP[fn] = rec
    return _REC_WRAP[fn]


def to_recording_tree(node):
    """Copy of the expression whose gather subtrees record their output."""
    if not isinstance(node, _Node):
        return node
    if needs_gather(node.fn):
        return _rebuilt(node, _rec_wrapper(node.fn), node.params)
    return _rebuilt(node, node.fn, _map_nodes(node.params, to_recording_tree))


# One field wrapper per eval function (as _REC_WRAP), so a routed tree has
# the same structure key and fingerprint every time; and the marks of the
# route per structure key of the expression.
_FIELD_WRAP = {}
_ROUTE_MEMO = {}
# route_fields' outputs by identity and dtype: (weak reference, ops).
_ROUTED = {}


def _field_wrapper(fn):
    if fn not in _FIELD_WRAP:
        if len(_FIELD_WRAP) > 256:
            _FIELD_WRAP.clear()

        @functools.wraps(fn)
        def field(q, p, _fn=fn):
            return _fn(q, p)

        _FIELD_WRAP[fn] = mark_gather(field)
    return _FIELD_WRAP[fn]


def _missing_op(node, dtype):
    """The op that node's own function cannot record in ``dtype`` (its
    child nodes standing in as field reads), or None when it records."""
    from . import eval_classify

    shell = _rebuilt(node, node.fn, _map_nodes(
        node.params, lambda c: _rebuilt(c, _placeholder_fn, ())))
    try:
        eval_classify.record(shell, 2 if isinstance(node, SDF2) else 3,
                             dtype)
    except eval_classify.NoCppForm as e:
        return e.op
    return None


def _route_marks(node, marks, dtype, at=0):
    """Walk the nodes in preorder from index ``at``: ``marks[i]`` is the
    missing op of the i-th node marked; a marked or gather node's subtree
    is not entered.  Returns the next index."""
    if needs_gather(node.fn):
        return at + 1
    op = _missing_op(node, dtype)
    if op is not None:
        marks[at] = op
        return at + 1
    at += 1
    for c in _child_nodes(node.params):
        at = _route_marks(c, marks, dtype, at)
    return at


def _apply_marks(node, marks, at):
    if needs_gather(node.fn):
        return node, at + 1
    if at in marks:
        return _rebuilt(node, _field_wrapper(node.fn), node.params), at + 1
    pos = [at + 1]

    def child(c):
        out, pos[0] = _apply_marks(c, marks, pos[0])
        return out

    params = _map_nodes(node.params, child)
    return _rebuilt(node, node.fn, params), pos[0]


def route_fields(sdf, stats=None, dtype=None):
    """``(tree, ops)``: the expression with each node whose own function
    does not record into the kernel body (``eval_classify.NoCppForm``)
    marked as a gather, so its subtree becomes a field that kernels B1 and
    B7 read; ``ops`` names the missing op of each marked node, in preorder.
    Only the smallest failing subtrees are marked: a node is tried with its
    child nodes as field reads, in ``dtype``, the one dtype the kernels
    run in (None: both; a general power has a form in float32 only).  Any
    other exception of the trial propagates.  An expression that records
    whole comes back as it is.  The trial is memoized per
    ``utils.checkpoint.structure_key`` and dtype, and a tree this function
    returned passes through at once.  With ``stats``
    (a ``LAST_STATS``-style dict), a route is recorded there as
    ``field_route_nodes`` and ``field_route_ops``."""
    if not isinstance(sdf, _Node):
        return sdf, ()
    f32 = dtype == torch.float32  # the only dtype whose trial differs
    hit = _ROUTED.get((id(sdf), f32))
    if hit is not None and hit[0]() is sdf:
        tree, ops = sdf, hit[1]
    else:
        key = (ckpt.structure_key(sdf), f32)
        marks = _ROUTE_MEMO.get(key)
        if marks is None:
            marks = {}
            _route_marks(sdf, marks, dtype)
            ckpt.memo_put(_ROUTE_MEMO, key, marks)
        ops = tuple(marks[i] for i in sorted(marks))
        tree = _apply_marks(sdf, marks, 0)[0] if marks else sdf
        ckpt.memo_put(_ROUTED, (id(tree), f32), (weakref.ref(tree), ops))
    if ops and stats is not None:
        stats["field_route_nodes"] = len(ops)
        stats["field_route_ops"] = ops
    return tree, ops


def record_tile_windows(rec_tree, Xw, Yw, Zw):
    """Gather fields for the per-tile kernel, one window per tile.

    ``rec_tree`` is a cast recording tree; Xw/Yw/Zw are (ntc, TS) per-tile
    coordinate windows on its device.  Returns a tuple of contiguous (ntc,
    TS, TS, TS) tensors, one per recorded evaluation, in evaluation order;
    the work scales with the active-tile count.  The root distance is
    discarded."""
    ntc, TS = Xw.shape
    shape = (ntc, TS, TS, TS)
    tape = _record(rec_tree, Points(Xw[:, :, None, None], Yw[:, None, :, None],
                                    Zw[:, None, None, :]))
    return tuple(
        torch.as_tensor(v, dtype=Xw.dtype, device=Xw.device)
        .broadcast_to(shape).contiguous()
        for v in tape
    )


def _record(rec_tree, p):
    """The recorded fields of one evaluation of ``rec_tree`` at ``p``."""
    tok = _TAPE.set([])
    try:
        rec_tree(p)
        return list(_TAPE.get())
    finally:
        _TAPE.reset(tok)


def record_dense_windows(rec_tree, Xt, Yt, Zt, chunk_points=2**22):
    """Gather fields for the dense kernel, over the whole grid.

    ``rec_tree`` is a cast recording tree; Xt/Yt/Zt are the axis tensors on
    its device.  Returns a tuple of contiguous (nx, ny, nz) tensors, one
    per recorded evaluation in evaluation order, in the layout of the
    dense volume (x-major, z fastest).  Evaluated in slabs of about
    ``chunk_points`` samples along x (the plain volume's chunks); the root
    distance is discarded."""
    nx, ny, nz = len(Xt), len(Yt), len(Zt)
    step = max(1, min(nx, -(-chunk_points // (ny * nz))))
    out = None
    for i in range(0, nx, step):
        xs = Xt[i: i + step]
        tape = _record(rec_tree, Points(xs[:, None, None], Yt[None, :, None],
                                        Zt[None, None, :]))
        if out is None:
            out = [torch.empty((nx, ny, nz), dtype=Xt.dtype, device=Xt.device)
                   for _ in tape]
        for o, v in zip(out, tape):
            o[i: i + step] = torch.as_tensor(
                v, dtype=Xt.dtype, device=Xt.device).broadcast_to(
                    (len(xs), ny, nz))
    return tuple(out or ())


def record_dense(sdf, Xt, Yt, Zt):
    """The pre-pass of the dense kernel: the recorded fields of the uncast
    expression ``sdf`` over the grid of the axis tensors Xt/Yt/Zt."""
    rec = cast(to_recording_tree(sdf), Xt.dtype, Xt.device)
    return record_dense_windows(rec, Xt, Yt, Zt)


def record_tiles(sdf, Xt, Yt, Zt, tiles, tile):
    """The pre-pass on a tile list: the recorded fields of the uncast
    expression ``sdf`` over the windows ``t * tile + [0, tile]`` of the
    (padded) axis tensors, for each row ``t`` of ``tiles`` (ntc, 3)."""
    off = torch.arange(tile + 1, device=tiles.device)
    t = tiles.to(torch.int64)
    Xw = Xt[t[:, 0:1] * tile + off]
    Yw = Yt[t[:, 1:2] * tile + off]
    Zw = Zt[t[:, 2:3] * tile + off]
    rec = cast(to_recording_tree(sdf), Xt.dtype, Xt.device)
    return record_tile_windows(rec, Xw, Yw, Zw)


class kernel_fields:
    """Context manager that supplies placeholder nodes with their fields:
    ``make(k)`` gives the k-th field in evaluation order (a tensor for the
    plain version, a recorded read for the generated body).  ``taken`` is
    the number handed out."""

    def __init__(self, make):
        self._make = make
        self.taken = 0
        self._tok = None

    def take(self):
        k = self.taken
        self.taken += 1
        return self._make(k)

    def __enter__(self):
        self._tok = _FIELDS.set(self)
        return self

    def __exit__(self, *exc):
        _FIELDS.reset(self._tok)
        return False
