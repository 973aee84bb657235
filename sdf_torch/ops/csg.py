"""Dimension-agnostic CSG operators (counterpart of ``sdf_tpu.ops.csg``).

Smooth-k semantics as in the JAX package: ``K = k or b._k`` -- the
explicit ``k`` wins unless falsy, only the right-hand operand's tag is
consulted, and the tag is read at evaluation time, so ``.k()`` applied
after an expression captured the node still takes effect.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..core.node import Points, as_param, node_k
from .vecmath import _abs, _max, _min, clip


def _resolve_k(k_param, b):
    """Evaluation-time K resolution: explicit op k, else the operand's tag."""
    return k_param if k_param is not None else node_k(b)


def union(a, *bs, k=None):
    k_param = as_param(k) if k else None  # falsy k -> fall back to b._k
    params = {"a": a, "bs": list(bs), "k": k_param}

    def fn(q, p):
        d1 = q["a"](p)
        for b in q["bs"]:
            d2 = b(p)
            K = _resolve_k(q["k"], b)
            if K is None:
                d1 = torch.minimum(d1, d2)
            else:
                h = clip(0.5 + 0.5 * (d2 - d1) / K, 0, 1)
                m = d2 + (d1 - d2) * h
                d1 = m - K * h * (1 - h)
        return d1

    return fn, params


def difference(a, *bs, k=None):
    k_param = as_param(k) if k else None
    params = {"a": a, "bs": list(bs), "k": k_param}

    def fn(q, p):
        d1 = q["a"](p)
        for b in q["bs"]:
            d2 = b(p)
            K = _resolve_k(q["k"], b)
            if K is None:
                d1 = torch.maximum(d1, -d2)
            else:
                h = clip(0.5 - 0.5 * (d2 + d1) / K, 0, 1)
                m = d1 + (-d2 - d1) * h
                d1 = m + K * h * (1 - h)
        return d1

    return fn, params


def intersection(a, *bs, k=None):
    k_param = as_param(k) if k else None
    params = {"a": a, "bs": list(bs), "k": k_param}

    def fn(q, p):
        d1 = q["a"](p)
        for b in q["bs"]:
            d2 = b(p)
            K = _resolve_k(q["k"], b)
            if K is None:
                d1 = torch.maximum(d1, d2)
            else:
                h = clip(0.5 - 0.5 * (d2 - d1) / K, 0, 1)
                m = d2 + (d1 - d2) * h
                d1 = m + K * h * (1 - h)
        return d1

    return fn, params


def blend(a, *bs, k=0.5):
    k_param = as_param(k) if k else None
    params = {"a": a, "bs": list(bs), "k": k_param}

    def fn(q, p):
        d1 = q["a"](p)
        for b in q["bs"]:
            d2 = b(p)
            K = _resolve_k(q["k"], b)
            d1 = K * d2 + (1 - K) * d1
        return d1

    return fn, params


def negate(other):
    def fn(q, p):
        return -q["other"](p)

    return fn, {"other": other}


def dilate(other, r):
    def fn(q, p):
        return q["other"](p) - q["r"]

    return fn, {"other": other, "r": as_param(r)}


def erode(other, r):
    def fn(q, p):
        return q["other"](p) + q["r"]

    return fn, {"other": other, "r": as_param(r)}


def shell(other, thickness):
    def fn(q, p):
        return _abs(q["other"](p)) - q["thickness"] / 2

    return fn, {"other": other, "thickness": as_param(thickness)}


def _per_axis(v, dim):
    """``jnp.broadcast_to(v, (dim,))`` as a list of per-axis entries."""
    shape = tuple(v.shape)
    if shape == ():
        return [v] * dim
    if shape == (1,):
        return [v[0]] * dim
    return [v[i] for i in range(dim)]


def repeat(other, spacing, count=None, padding=0):
    """Lattice repetition with optional finite count and neighbour padding
    (see sdf_tpu.ops.csg.repeat; the stencil is fixed at construction)."""
    spacing_np = np.atleast_1d(np.asarray(spacing, dtype=np.float64))
    params = {
        "other": other,
        "spacing": as_param(spacing),
        "count": as_param(count) if count is not None else None,
    }

    def _neighbors(dim):
        try:
            pad = [padding[i] for i in range(dim)]
        except (TypeError, IndexError):
            pad = [padding] * dim
        try:
            sp = [spacing_np[i] for i in range(dim)]
        except IndexError:
            sp = [float(spacing_np.reshape(-1)[0])] * dim
        for i, s in enumerate(sp):
            if s == 0:
                pad[i] = 0
        axes = [list(range(-p, p + 1)) for p in pad]
        return list(itertools.product(*axes))

    def fn(q, p):
        dim = p.dim
        nonzero = np.broadcast_to(spacing_np != 0, (dim,))
        sp = _per_axis(q["spacing"], dim)
        if q["count"] is not None:
            cnt = _per_axis(q["count"], dim)
        index = []
        for i in range(dim):
            if not nonzero[i]:
                index.append(None)
                continue
            idx = torch.round(p.c[i] / sp[i])
            if q["count"] is not None:
                idx = clip(idx, -cnt[i], cnt[i])
            index.append(idx)
        ds = []
        for n in _neighbors(dim):
            shifted = Points(
                *[
                    p.c[i]
                    if index[i] is None
                    else p.c[i] - sp[i] * (index[i] + n[i])
                    for i in range(dim)
                ]
            )
            ds.append(q["other"](shifted))
        a = ds[0]
        for b in ds[1:]:
            a = torch.minimum(a, b)
        return a

    return fn, params
