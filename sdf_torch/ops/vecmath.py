"""Shared SoA vector helpers for the op libraries (counterpart of
``sdf_tpu.ops.vecmath``).

Every helper keeps the JAX package's arithmetic in the same order --
Python ``sum`` starting from integer 0, ``clip`` as ``minimum(hi,
maximum(lo, x))``, ``hypot`` as ``jnp.hypot`` computes it -- so float64
volumes stay bit-equal to the reference.  The helpers call torch
functions and Python operators only: the same code runs on tensors and on
the symbolic recorder that generates the CUDA eval kernel
(``core.eval_classify``).

Gradients follow JAX's rules where the two libraries differ: abs' is 1
at 0 (torch's is 0), a tie of ``minimum``/``maximum`` against a Python
number splits the gradient 0.5 to each side (``torch.clamp`` gives it all
to the tensor), and atan2's derivative at the origin is NaN (torch's is
0).  ``_abs``, ``_min``, ``_max`` and ``arctan2`` apply them through
small ``autograd.Function``s whose forward is the same torch call, so
values do not change; the CPU ``sqrt`` keeps numpy's IEEE forward with
the derivative ``g / (2 * out)``.  Symbolic values of the recorder are
not tensors and take the plain torch calls, so the kernel source does not
change either.

One trap of PyTorch's CUDA division: a tensor divided by a Python float
is computed as a multiply by the float's reciprocal.  That is exact for
powers of two only, so ops divide by Python floats only where the float
is a power of two, and otherwise divide by a tensor.
"""

from __future__ import annotations

import math
import numbers

import numpy as np
import torch

from ..core.node import Points

_vec = Points


def _is_num(x):
    return isinstance(x, numbers.Number)


def _recorded(x):
    """Whether autograd records an op on ``x``."""
    return (isinstance(x, torch.Tensor) and x.requires_grad
            and torch.is_grad_enabled())


class _Abs(torch.autograd.Function):
    """``torch.abs`` with JAX's derivative: -1 below 0, else 1."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


class _ClampNum(torch.autograd.Function):
    """``torch.clamp`` of a tensor against the Python number ``b`` (from
    above when ``upper``) with ``jnp.minimum``/``jnp.maximum``'s
    derivative: 1 where the tensor wins, 0.5 at a tie, 0 where ``b`` wins."""

    @staticmethod
    def forward(ctx, x, b, upper):
        ctx.save_for_backward(x)
        ctx.b, ctx.upper = b, upper
        return torch.clamp(x, max=b) if upper else torch.clamp(x, min=b)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        wins = x < ctx.b if ctx.upper else x > ctx.b
        half = torch.where(x == ctx.b, g * 0.5, torch.zeros_like(g))
        return torch.where(wins, g, half), None, None


class _SqrtIEEE(torch.autograd.Function):
    """numpy's correctly rounded sqrt of a CPU tensor; derivative
    ``g / (2 * out)``, torch's own for ``torch.sqrt``."""

    @staticmethod
    def forward(ctx, x):
        out = torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return g / (2 * out)


class _Atan2(torch.autograd.Function):
    """``torch.atan2(y, x)`` with JAX's derivative, ``g * x / (y^2 + x^2)``
    and ``g * -y / (y^2 + x^2)``: NaN at the origin, where torch's own is
    0."""

    @staticmethod
    def forward(ctx, y, x):
        ctx.save_for_backward(y, x)
        return torch.atan2(y, x)

    @staticmethod
    def backward(ctx, g):
        y, x = ctx.saved_tensors
        r = y * y + x * x
        return g * (x / r), g * (-y / r)


def _abs(x):
    """``jnp.abs``: the one absolute value of the ops (JAX's derivative)."""
    return _Abs.apply(x) if _recorded(x) else torch.abs(x)


def _clamp_num(x, b, upper):
    if _recorded(x):
        return _ClampNum.apply(x, b, upper)
    return torch.clamp(x, max=b) if upper else torch.clamp(x, min=b)


def _min(a, b):
    """``jnp.minimum`` for any mix of tensors and Python numbers."""
    if _is_num(a) and _is_num(b):
        return min(a, b)
    if _is_num(b):
        return _clamp_num(a, b, True)
    if _is_num(a):
        return _clamp_num(b, a, True)
    return torch.minimum(a, b)


def _max(a, b):
    """``jnp.maximum`` for any mix of tensors and Python numbers."""
    if _is_num(a) and _is_num(b):
        return max(a, b)
    if _is_num(b):
        return _clamp_num(a, b, False)
    if _is_num(a):
        return _clamp_num(b, a, False)
    return torch.maximum(a, b)


def sqrt(x):
    """Correctly rounded square root.  PyTorch's vectorized CPU sqrt is a
    SLEEF approximation (off by one ulp on ~0.8% of inputs), so CPU
    tensors take numpy's IEEE sqrt; CUDA's sqrt is IEEE already."""
    if isinstance(x, torch.Tensor) and x.device.type == "cpu":
        return _SqrtIEEE.apply(x)
    return torch.sqrt(x)


def clip(x, lo, hi):
    """``jnp.clip``: ``minimum(hi, maximum(lo, x))``."""
    return _min(hi, _max(lo, x))


def hypot(x1, x2):
    """``jnp.hypot``, op for op."""
    x1, x2 = _abs(x1), _abs(x2)
    idx_inf = (x1 == math.inf) | (x2 == math.inf)
    x1, x2 = torch.maximum(x1, x2), torch.minimum(x1, x2)
    r = x2 / torch.where(x1 == 0, 1.0, x1)
    x = torch.where(x1 == 0, x1, x1 * sqrt(1 + r * r))
    return torch.where(idx_inf, math.inf, x)


def arctan2(y, x):
    """``jnp.arctan2`` (JAX's derivative, NaN at the origin)."""
    if _recorded(y) or _recorded(x):
        return _Atan2.apply(*torch.broadcast_tensors(
            torch.as_tensor(y), torch.as_tensor(x)))
    return torch.atan2(y, x)


def _div_const(x, c):
    """``x / c`` for a Python float ``c`` as a true division on every
    device (see the module note on CUDA scalar division)."""
    return x / torch.full_like(x, c)


def _mod(a, b):
    """``jnp.remainder`` (sign of the divisor) for a Python float ``b``, op
    for op: C ``fmod`` plus the same sign fix."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _dotv(a, b):
    """Scalar dot of two tiny parameter vectors as explicit multiply-adds."""
    return sum(a[i] * b[i] for i in range(a.shape[0]))


def _length(a):
    # Double-where safe norm, value-identical to the JAX package's.
    sq = sum(c * c for c in a.c)
    return torch.where(sq == 0, 0.0, sqrt(torch.where(sq == 0, 1.0, sq)))


def _normalize(a):
    return a / np.linalg.norm(a)


def _dot(a, b):
    return sum(x * y for x, y in zip(a.c, b.c))


def _entry(m, *idx):
    """One entry of a parameter vector/matrix: a numpy constant enters as a
    Python float (rounded to the field dtype like a weak JAX literal)."""
    if isinstance(m, np.ndarray):
        return float(m[idx])
    return m[idx]


def _mdot(p, m):
    """``p @ m`` for Points and a tiny vector/matrix, as explicit
    multiply-adds."""
    if isinstance(m, (list, tuple)):
        m = np.asarray(m, dtype=np.float64)
    if len(m.shape) == 1:
        return sum(c * _entry(m, i) for i, c in enumerate(p.c))
    return Points(
        *[
            sum(c * _entry(m, i, j) for i, c in enumerate(p.c))
            for j in range(m.shape[1])
        ]
    )


def _vmul(v, s):
    """Per-component product of a tiny (d,) vector with a field array."""
    return Points(*[_entry(v, i) * s for i in range(v.shape[0])])


def _pmax(a, b):
    """Componentwise maximum of Points against a scalar or Points."""
    if isinstance(b, Points):
        return Points(*[_max(x, y) for x, y in zip(a.c, b.c)])
    return Points(*[_max(x, b) for x in a.c])
