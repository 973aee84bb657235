"""Field inputs for subtrees the generated eval kernel cannot hold
(counterpart of ``sdf_tpu.core.hybrid``, as far as the per-tile kernel
with field inputs needs it).

Some SDF nodes need gathers (a table or texture lookup by a computed
index), which have no statement form in the generated per-point body of
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

Fields and placeholder reads pair up by order: both passes run the same
tree with the same non-gather code, so child calls happen in the same
sequence.  ``record_tile_windows`` is the pre-pass of the tiled path, plain
torch ops outside any kernel.  PyTorch prunes nothing, so the pre-pass
evaluates the whole tree once on the tiles' points, not only the gather
subtrees.  The dense kernel takes no field inputs yet, and the
gather-bearing ops themselves (textures, mesh SDFs, polygons) are not
ported yet.
"""

from __future__ import annotations

import contextvars

import torch

from .node import Points, _Node, cast

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
    by ``f(node)``; other leaves are shared."""
    if isinstance(tree, _Node):
        return f(tree)
    if isinstance(tree, dict):
        return {key: _map_nodes(v, f) for key, v in tree.items()}
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


def record_tile_windows(rec_tree, Xw, Yw, Zw):
    """Gather fields for the per-tile kernel, one window per tile.

    ``rec_tree`` is a cast recording tree; Xw/Yw/Zw are (ntc, TS) per-tile
    coordinate windows on its device.  Returns a tuple of contiguous (ntc,
    TS, TS, TS) tensors, one per recorded evaluation, in evaluation order;
    the work scales with the active-tile count.  The root distance is
    discarded."""
    ntc, TS = Xw.shape
    shape = (ntc, TS, TS, TS)
    tok = _TAPE.set([])
    try:
        rec_tree(Points(Xw[:, :, None, None], Yw[:, None, :, None],
                        Zw[:, None, None, :]))
        return tuple(
            torch.as_tensor(v, dtype=Xw.dtype, device=Xw.device)
            .broadcast_to(shape).contiguous()
            for v in _TAPE.get()
        )
    finally:
        _TAPE.reset(tok)


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
