"""Checkpoint / resume for grid generation, and the fingerprints the
engine's memos key on (counterpart of ``sdf_tpu.utils.checkpoint``).

``generate(..., checkpoint=path)`` persists the triangle soup together
with a fingerprint of the run configuration (grid + expression parameters
+ closure statics); a re-run with an identical configuration loads the
result instead of recomputing, and separate processes can each write a
shard file and assemble them afterwards with ``merge``.

The fingerprint walks the port's own parameter trees
(``node.tree_leaves``); it is stable across processes but is not the JAX
package's digest, so checkpoint files do not carry across the packages.
"""

from __future__ import annotations

import hashlib
import os
import re
import types

import numpy as np
import torch

from ..core.node import _Node, tree_leaves, tree_map


def _feed_array(h, a):
    a = np.ascontiguousarray(np.asarray(a))
    # Shape/dtype prefix: raw byte concatenation is boundary-blind
    # (X=[0,1,2],Y=[3,4] would collide with X=[0,1],Y=[2,3,4]).
    h.update(repr((a.shape, a.dtype.str)).encode())
    h.update(a.tobytes())


def _feed_static(h, obj, seen):
    """Hash a *static* Python object reachable from an expression.

    Statics live outside the parameter tree: values captured in op closures
    (circular_array's angle step, repeat's padding stencil, an easing
    function passed as a shape argument).  Two expressions that differ
    only in such a capture produce different fingerprints.  Cycles and
    shared objects are broken with an id-memo; the memo marker itself is
    fed so aliasing structure stays part of the hash.
    """
    i = id(obj)
    if i in seen:
        # Positional marker: WHICH previously-seen object this aliases
        # matters (interned small ints make a bare marker collide).
        h.update(b"<cyc:%d>" % seen[i])
        return
    if isinstance(obj, types.FunctionType):
        seen[i] = len(seen)
        code = obj.__code__
        h.update(code.co_code)
        # co_names carries referenced globals/attributes: `abs(p.x)-1`
        # and `abs(p.y)-1` compile to identical co_code and differ only
        # here.
        h.update(repr(code.co_names).encode())
        for const in code.co_consts:
            _feed_static(h, const, seen)
        for cell in obj.__closure__ or ():
            try:
                _feed_static(h, cell.cell_contents, seen)
            except ValueError:  # empty cell
                h.update(b"<empty>")
        for v in (obj.__defaults__ or ()):
            _feed_static(h, v, seen)
        return
    if isinstance(obj, types.CodeType):  # nested lambdas in co_consts
        seen[i] = len(seen)
        h.update(obj.co_code)
        h.update(repr(obj.co_names).encode())
        for const in obj.co_consts:
            _feed_static(h, const, seen)
        return
    if isinstance(obj, torch.Tensor):
        _feed_array(h, obj.detach().cpu().numpy())
        return
    if isinstance(obj, (np.ndarray, np.generic)):
        _feed_array(h, obj)
        return
    if isinstance(obj, (int, float, complex, bool, str, bytes, type(None))):
        h.update(repr(obj).encode())
        return
    if isinstance(obj, (tuple, list)):
        seen[i] = len(seen)
        h.update(b"<seq>")
        for v in obj:
            _feed_static(h, v, seen)
        return
    if isinstance(obj, dict):
        seen[i] = len(seen)
        h.update(b"<map>")
        for k in obj:
            h.update(repr(k).encode())
            _feed_static(h, obj[k], seen)
        return
    # SDF nodes, at the root or captured inside closures: hash the eval
    # function and everything reachable from the parameters.
    fn = getattr(obj, "fn", None)
    params = getattr(obj, "params", None)
    if callable(fn) and params is not None:
        seen[i] = len(seen)
        h.update(type(obj).__name__.encode())
        _feed_static(h, fn, seen)
        _feed_static(h, params, seen)
        return
    # Fallback: repr with memory addresses stripped (stable across runs).
    seen[i] = len(seen)
    h.update(re.sub(r"0x[0-9a-f]+", "", repr(obj)).encode())


def _structure(tree):
    """The tree's shape as text: node types and eval-function names, dict
    keys, sequence lengths, ``None`` slots and a ``*`` per leaf, in
    ``tree_leaves`` order.  What a pytree definition's repr says, without
    memory addresses."""
    if tree is None:
        return "None"
    if isinstance(tree, _Node):
        name = getattr(tree.fn, "__qualname__", type(tree.fn).__name__)
        return "%s[%s](%s,k=%s)" % (
            type(tree).__name__, name, _structure(tree.params),
            _structure(tree._k),
        )
    if isinstance(tree, dict):
        return "{%s}" % ",".join(
            "%r:%s" % (key, _structure(tree[key])) for key in sorted(tree)
        )
    if isinstance(tree, (list, tuple)):
        return "%s(%s)" % (
            type(tree).__name__, ",".join(_structure(x) for x in tree)
        )
    return "*"


def _host_leaves(leaves):
    """Every leaf as a numpy array.  Leaves that live on a card are fetched
    in ONE transfer per dtype (a ``.cpu()`` per leaf would wait for the
    device once each)."""
    out = list(leaves)
    groups = {}
    for idx, leaf in enumerate(out):
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
            groups.setdefault((leaf.device, leaf.dtype), []).append(idx)
    for idxs in groups.values():
        flat = torch.cat([out[i].detach().reshape(-1) for i in idxs]).cpu()
        at = 0
        for i in idxs:
            n = out[i].numel()
            out[i] = flat[at: at + n].reshape(out[i].shape).numpy()
            at += n
    return [
        x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in out
    ]


def _legacy_closures(tree):
    """Whether the expression holds a reference-style closure
    (``node._wrap_legacy``)."""
    if isinstance(tree, _Node):
        return (getattr(tree.fn, "legacy_closure", False)
                or _legacy_closures(tree.params) or _legacy_closures(tree._k))
    if isinstance(tree, dict):
        return any(_legacy_closures(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_legacy_closures(v) for v in tree)
    return False


def fingerprint(sdf, X, Y, Z, sparse):
    """Stable hash of the run configuration: grid + full expression.

    Covers the grid coordinates, the extras ``sparse`` (any repr-able
    value), the expression tree (structure + parameter leaves -- texture
    arrays, mesh grids and polygon vertices among them -- and ``.k()``
    tags) AND all closure-captured statics of every node's eval function
    -- a model that differs only in a static (e.g. ``circular_array(4)``
    vs ``circular_array(12)``) never hits the same entry.

    A reference-style closure has no leaves: what it computes may hang on
    anything it reaches, so it has no fingerprint and this raises
    ``ValueError`` (the engine's memos then recompute).
    """
    if _legacy_closures(sdf):
        raise ValueError(
            "an expression with a reference-style closure has no "
            "fingerprint: the closure captures its values where the "
            "parameter tree cannot see them")
    h = hashlib.sha256()
    for a in (X, Y, Z):
        _feed_array(h, a)
    h.update(repr(sparse).encode())  # True/False/"tiles" differ (order!)
    leaves = tree_leaves(sdf)
    h.update(_structure(sdf).encode())
    for leaf in _host_leaves(leaves):
        _feed_array(h, leaf)
    # Statics: every eval fn in the tree, including closure captures.  The
    # leaves are hashed above, so pre-mark them visited: the static walk
    # then neither re-hashes parameter arrays nor fetches them again.
    seen = {id(leaf): idx for idx, leaf in enumerate(leaves)}
    _feed_static(h, sdf, seen)
    return h.hexdigest()


MEMO_MAX = 256


def memo_put(memo, key, value):
    """Store ``value`` under a fingerprint-derived ``key`` in one of the
    engine's memo dicts; a ``None`` key (an expression that cannot be
    hashed) stores nothing, and a memo past ``MEMO_MAX`` entries is
    emptied first."""
    if key is None:
        return
    if len(memo) > MEMO_MAX:
        memo.clear()
    memo[key] = value


def structure_key(sdf, *extra):
    """Fingerprint of an expression's *structure* (statics + tree shape +
    leaf shapes, no leaf values).  Rebuilding the same model yields fresh
    function identities, so identity is useless as a cache key; this hash
    is stable across rebuilds and processes: the key for anything that
    depends on the expression's program and not on its parameter values."""
    h = hashlib.sha256()
    h.update(_structure(sdf).encode())
    skeleton = tree_map(
        lambda x: (tuple(np.shape(x)),
                   str(getattr(x, "dtype", None) or np.asarray(x).dtype)),
        sdf,
    )
    _feed_static(h, skeleton, {})
    for e in extra:
        h.update(repr(e).encode())
    return h.hexdigest()


def load(path, fp):
    """The checkpointed points if ``path`` holds fingerprint ``fp``, else
    None (also for a missing or unreadable file)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            if str(z["fingerprint"]) != fp:
                return None
            return z["points"]
    except Exception:
        return None


def save(path, fp, points):
    # numpy appends .npz unless the name already ends with it
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, fingerprint=fp, points=points)
    os.replace(tmp, path)


def merge(paths):
    """Concatenate per-shard checkpoint files into one triangle soup."""
    parts = []
    for p in paths:
        with np.load(p) as z:
            parts.append(z["points"])
    return np.concatenate(parts, axis=0)
