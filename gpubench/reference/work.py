"""The yardstick's count of the work a sample of an expression costs.

``flops_per_sample`` evaluates the reference expression on points that are
full tensors of ``n`` entries and counts each torch call that returns a
floating tensor of ``n`` entries as one operation a sample: an add,
subtract, multiply, divide, minimum, maximum or clamp, a square root, and
each of ``sin``, ``cos``, ``atan2`` and ``fmod`` as one.  Not counted:
selects (``where``), comparisons, absolute values and negations (operand
modifiers on the card), copies, and an add of the integer 0 that Python's
``sum`` starts from.  Transcendentals counted as one make the count a lower
bound on the card's instructions, which is the side a roofline's least
time may err on.  Operations on parameters alone are not per sample.

The configuration files hold the result as frozen data
(``work.flops_per_sample``); a test recomputes it from this module.
"""

from __future__ import annotations

import torch
from torch.overrides import TorchFunctionMode

from .sdf import Points, field

_FREE = {"where", "abs", "__abs__", "neg", "__neg__", "clone", "to",
         "contiguous", "broadcast_to", "expand", "reshape", "view",
         "__getitem__", "as_tensor", "zeros_like", "full_like"}
_COMPARE = {"__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__",
            "eq", "ne", "lt", "le", "gt", "ge", "__and__", "__or__",
            "__invert__", "logical_and", "logical_or", "all"}


class _Count(TorchFunctionMode):
    def __init__(self, n):
        super().__init__()
        self.n = n
        self.ops = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", str(func))
        if (isinstance(out, torch.Tensor) and out.is_floating_point()
                and out.numel() == self.n and name not in _FREE
                and name not in _COMPARE
                and not (name in ("__add__", "__radd__", "add")
                         and any(isinstance(a, int) and a == 0
                                 for a in args))):
            self.ops[name] = self.ops.get(name, 0) + 1
        return out


def flops_per_sample(expr, n=4096, seed=0):
    """``(total, {torch call: count})`` for one sample of ``expr``."""
    g = torch.Generator().manual_seed(seed)
    pts = (torch.rand((3, n), generator=g, dtype=torch.float64) * 8 - 4).to(
        torch.float32)
    f = field(expr, torch.float32, "cpu")
    with _Count(n) as mode:
        f(Points(*pts))
    return sum(mode.ops.values()), dict(sorted(mode.ops.items()))
