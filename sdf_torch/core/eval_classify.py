"""Fused eval + classify (counterpart of ``sdf_tpu.core.pallas_eval``): the
dense grid, and the active tiles of the tiled sparse path.

``eval_and_classify`` evaluates an SDF expression over the grid
``X x Y x Z`` and returns the volume with each cell's 8-bit corner-sign
case code.  On the card it launches kernel B1 (``csrc/eval_classify.cu``),
whose per-point body is generated from the expression here: the
expression's own torch code runs once on ``Rec`` values, a recorder that
turns every torch function and Python operator into one C++ statement.
The fields of gather-bearing subtrees are recorded ahead over the whole
grid by ``core.hybrid.record_dense_windows`` and read by the body at the
sample's own index.  On the CPU it runs the plain pair ``_eval_volume`` +
``mc._cell_cases`` on the same fields, which is also what
``chip_smoke.py`` holds the kernel against.  ``bounds_probe`` evaluates
the engine's bounds refinement rounds on the card with a second kernel of
B1's library, from the same body.

``eval_tiles_and_classify_batched`` (kernel B6) and
``eval_tiles_and_classify`` (kernel B7) do the same for a list of tiles,
each a ``(tile+1)^3`` sample cube: B6 on the unpadded axes with indices
clamped to the grid, for expressions the body can hold whole; B7 on axes
padded by one tile, with the fields of gather-bearing subtrees computed
ahead by ``core.hybrid`` and read by the body.  Both launch the one
instantiation per dtype of ``csrc/eval_tiles.cu`` (launch plan
``tile_plan``) and share B1's per-point body (``csrc/sdf_point.cuh``).
With ``live`` they evaluate the live rows and one padded row and copy it
over the rest.  Their plain pair is ``_eval_tiles`` + ``mc._cell_cases``.

An op, operator or tensor method with no C++ form raises ``NoCppForm``
(a ``NotImplementedError``) naming it; ``core.hybrid.route_fields``, which
the engine applies before any of these kernels, turns each node whose own
function raises it into a field that the kernels read.
"""

from __future__ import annotations

import ctypes
import math
import numbers
import weakref

import numpy as np
import torch

from .. import _build
from . import hybrid, spans
from .mc import _cell_cases
from .node import Points, cast, fetch, tree_leaves, tree_map, upload

_TARGET_CHUNK_POINTS = 2**22
_BODY_MARK = "//@SDF_BODY@"
_PARAMS_MARK = "//@SDF_PARAMS@"
_POINT_INCLUDE = '#include "sdf_point.cuh"'
MAX_FIELDS = 32  # csrc/sdf_point.cuh MAX_FIELDS
# Parameters up to this count travel by value in the kernel arguments (the
# card's constant bank): 384 float64 values are 3 KB, which leaves room in
# the 4 KB of arguments for B7's 32 field pointers and the rest.  A wider
# expression reads them from device memory (csrc/sdf_point.cuh Params).
MAX_ARG_PARAMS = 384


# --- the recorder -------------------------------------------------------------


class _Emitter:
    """Collects the generated body: one ``const`` statement per op.
    ``dtype`` is the one dtype the body will run in, or None for both."""

    def __init__(self, dtype=None):
        self.lines = []
        self.dtype = dtype

    def var(self, kind, expr):
        name = "v%d" % len(self.lines)
        ctype = "T" if kind == "f" else "bool"
        self.lines.append("  const %s %s = %s;" % (ctype, name, expr))
        return name


def _lit(v):
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    v = float(v)
    if math.isnan(v):
        return "T(NAN)"
    if math.isinf(v):
        return "T(INFINITY)" if v > 0 else "T(-INFINITY)"
    return "T(%r)" % v


def _scalar(expr):
    a = np.empty((), dtype=object)
    a[()] = expr
    return a


def _kind_of(v):
    return "b" if isinstance(v, (bool, np.bool_)) else "f"


class NoCppForm(NotImplementedError):
    """An op, operator or tensor method that the generated per-point body
    cannot hold: it has no C++ form in ``csrc/sdf_point.cuh``.  ``op`` is
    its name."""

    def __init__(self, op):
        self.op = op
        super().__init__("op %r has no C++ form in the CUDA eval kernel" % op)


# torch.pow by a Python number (ATen's pow.Tensor_Scalar on CUDA): these
# exponents take their own kernels; any other one calls pow (Rec._pow).
_POW_NUMBER = {0: "T(1)", 1: "{0}", 2: "({0} * {0})", 3: "({0} * {0} * {0})",
               0.5: "op_sqrt({0})", -0.5: "op_rsqrt({0})", -1: "(T(1) / {0})",
               -2: "(T(1) / ({0} * {0}))"}


def _is_number(v):
    return isinstance(v, numbers.Number) and not isinstance(v, bool)


class Rec:
    """A symbolic value: an object array of C++ expressions (0-d for a
    per-point field value, (3,) or (3, 3) for a parameter leaf) of kind
    ``"f"`` (the float type T) or ``"b"`` (bool)."""

    __slots__ = ("em", "expr", "kind")
    __hash__ = None

    def __init__(self, em, expr, kind="f"):
        self.em = em
        self.expr = _scalar(expr) if isinstance(expr, str) else expr
        self.kind = kind

    @property
    def shape(self):
        return self.expr.shape

    @property
    def ndim(self):
        return self.expr.ndim

    def __getitem__(self, idx):
        sub = self.expr[idx]
        if not isinstance(sub, np.ndarray):
            sub = _scalar(sub)
        return Rec(self.em, sub, self.kind)

    def __bool__(self):
        raise NotImplementedError(
            "data-dependent Python control flow cannot be compiled into the "
            "CUDA eval kernel"
        )

    # -- elementwise recording --
    def _ops(self, *args):
        """Each argument as (object array of C++ expressions, kind)."""
        out = []
        for a in args:
            if isinstance(a, Rec):
                out.append((a.expr, a.kind))
            elif isinstance(a, numbers.Number):
                out.append((_scalar(_lit(a)), _kind_of(a)))
            elif isinstance(a, torch.Tensor) and a.device.type == "cpu":
                # A constant the op made (never a parameter: those are Recs).
                vals = np.vectorize(_lit, otypes=[object])(a.numpy())
                kind = "b" if a.dtype == torch.bool else "f"
                out.append((np.asarray(vals, dtype=object), kind))
            else:
                return None
        return out

    def _map(self, fmt, args, kind):
        ops = self._ops(*args)
        if ops is None:
            return NotImplemented
        if all(o[0].ndim == 0 for o in ops):  # the common per-point case
            expr = fmt.format(*[o[0][()] for o in ops])
            return Rec(self.em, self.em.var(kind, expr), kind)
        arrs = np.broadcast_arrays(*[o[0] for o in ops])
        res = np.empty(arrs[0].shape, dtype=object)
        for i in np.ndindex(res.shape):
            res[i] = self.em.var(kind, fmt.format(*[a[i] for a in arrs]))
        return Rec(self.em, res, kind)

    def __add__(self, o):
        return self._map("({} + {})", (self, o), "f")

    def __radd__(self, o):
        return self._map("({} + {})", (o, self), "f")

    def __sub__(self, o):
        return self._map("({} - {})", (self, o), "f")

    def __rsub__(self, o):
        return self._map("({} - {})", (o, self), "f")

    def __mul__(self, o):
        return self._map("({} * {})", (self, o), "f")

    def __rmul__(self, o):
        return self._map("({} * {})", (o, self), "f")

    def __truediv__(self, o):
        if isinstance(o, numbers.Number):
            # PyTorch's CUDA division by a Python number multiplies by its
            # reciprocal (exact for the powers of two the ops use).
            return self._map("({} * (T(1) / {}))", (self, o), "f")
        return self._map("({} / {})", (self, o), "f")

    def __rtruediv__(self, o):
        # PyTorch computes ``number / tensor`` as reciprocal(tensor) * number.
        return self._map("((T(1) / {}) * {})", (self, o), "f")

    def __neg__(self):
        return self._map("(-{})", (self,), "f")

    def __abs__(self):
        return self._map("op_abs({})", (self,), "f")

    def __pow__(self, o):
        if _is_number(o) and o in _POW_NUMBER:
            return self._map(_POW_NUMBER[o], (self,), "f")
        return self._pow(self, o)

    def __rpow__(self, o):
        # ATen's pow.Scalar: a base of 1 fills, any other calls pow.
        if _is_number(o) and o == 1:
            return self._map("T(1)", (self,), "f")
        return self._pow(o, self)

    def _pow(self, a, b):
        # The library's pow, as ATen's kernel calls it: in float32 it equals
        # PyTorch's on the card; in float64 it differs from it by an ulp
        # now and then (PyTorch's build contracts the library's pow into
        # FMAs), but for a base of 2.  So a general power has a float64
        # form only as 2 ** t, and a body for both dtypes has none.
        if self.em.dtype == torch.float32 or (_is_number(a) and a == 2):
            return self._map("op_pow({}, {})", (a, b), "f")
        raise NoCppForm("pow")

    def __mod__(self, o):
        return self._map("op_remainder({}, {})", (self, o), "f")

    def __rmod__(self, o):
        return self._map("op_remainder({}, {})", (o, self), "f")

    def __floordiv__(self, o):
        if _is_number(o):
            if o == 0:  # ATen takes the true division by the number
                return self / o
            return self._map("op_floordiv_number({}, {})", (self, o), "f")
        return self._map("op_floordiv({}, {})", (self, o), "f")

    def __rfloordiv__(self, o):
        return self._map("op_floordiv({}, {})", (o, self), "f")

    def __lt__(self, o):
        return self._map("({} < {})", (self, o), "b")

    def __le__(self, o):
        return self._map("({} <= {})", (self, o), "b")

    def __gt__(self, o):
        return self._map("({} > {})", (self, o), "b")

    def __ge__(self, o):
        return self._map("({} >= {})", (self, o), "b")

    def __eq__(self, o):
        return self._map("({} == {})", (self, o), "b")

    def __ne__(self, o):
        return self._map("({} != {})", (self, o), "b")

    def __and__(self, o):
        return self._map("({} && {})", (self, o), "b")

    __rand__ = __and__

    def __or__(self, o):
        return self._map("({} || {})", (self, o), "b")

    __ror__ = __or__

    def __invert__(self):
        return self._map("(!{})", (self,), "b")

    def __getattr__(self, name):
        # A tensor method whose torch function takes the tensor first, as
        # the method does, records as that function (``x.tanh()``); any
        # other tensor method has no form (``t.where(c, y)`` is
        # ``torch.where(c, t, y)``, not ``torch.where(t, c, y)``).
        if name.startswith("_") or not hasattr(torch.Tensor, name):
            raise AttributeError(name)
        if name not in _METHODS:
            raise NoCppForm(name)
        func = _METHODS[name]
        return lambda *args, **kwargs: Rec.__torch_function__(
            func, (Rec,), (self,) + args, kwargs)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", repr(func))
        kwargs = kwargs or {}
        rec = next(a for a in list(args) + list(kwargs.values())
                   if isinstance(a, Rec))
        # A form takes exactly its operands: an option it would ignore
        # (``torch.round(x, decimals=1)``, ``out=``) has no form.
        arity = _ARITY.get(func)
        if arity is not None and (len(args) != arity or kwargs):
            raise NoCppForm(name)
        if func is torch.clamp and (len(args) > 3
                                    or set(kwargs) - {"min", "max"}):
            raise NoCppForm(name)
        if func in _UNARY:
            return rec._map(_UNARY[func], args, "f")
        if func in _BINARY:
            return rec._map(_BINARY[func], args, "f")
        if func is torch.pow:
            a, b = args
            return a.__pow__(b) if isinstance(a, Rec) else b.__rpow__(a)
        if func is torch.floor_divide:
            a, b = args
            return (a.__floordiv__(b) if isinstance(a, Rec)
                    else b.__rfloordiv__(a))
        if func is torch.lerp:
            return rec._map("op_lerp({}, {}, {})", args, "f")
        if func is torch.where:
            return rec._map("({} ? {} : {})", args, "f")
        if func is torch.logical_and:
            return rec._map("({} && {})", args, "b")
        if func is torch.clamp:
            x = args[0]
            lo = kwargs.get("min", args[1] if len(args) > 1 else None)
            hi = kwargs.get("max", args[2] if len(args) > 2 else None)
            if lo is not None:
                x = rec._map("op_max({}, {})", (x, lo), "f")
            if hi is not None:
                x = rec._map("op_min({}, {})", (x, hi), "f")
            return x
        if func in (torch.zeros_like, torch.ones_like, torch.full_like):
            v = {torch.zeros_like: 0.0, torch.ones_like: 1.0}.get(func)
            v = args[1] if v is None else v
            expr = np.empty(args[0].shape, dtype=object)
            expr[...] = _lit(v)
            return Rec(rec.em, expr)
        raise NoCppForm(name)


# Each form computes what PyTorch's CUDA kernel of the op computes, so the
# plain version on the card is bit-equal (chip_smoke.py phase 22).
_UNARY = {
    torch.abs: "op_abs({})",
    torch.sqrt: "op_sqrt({})",
    torch.cos: "op_cos({})",
    torch.sin: "op_sin({})",
    torch.round: "op_round({})",
    torch.sign: "op_sign({})",
    torch.neg: "(-{})",
    torch.square: "({0} * {0})",
    torch.reciprocal: "(T(1) / {})",
    torch.exp2: "op_exp2({})",
}
_UNARY.update({getattr(torch, name): "op_%s({})" % name for name in (
    "tanh", "exp", "expm1", "log", "log1p", "log2", "tan", "atan", "asin",
    "acos", "sinh", "cosh", "floor", "ceil", "trunc", "rsqrt")})
_UNARY.update({torch.arctan: _UNARY[torch.atan],
               torch.arcsin: _UNARY[torch.asin],
               torch.arccos: _UNARY[torch.acos]})
_BINARY = {
    torch.minimum: "op_min({}, {})",
    torch.maximum: "op_max({}, {})",
    torch.atan2: "op_atan2({}, {})",
    torch.fmod: "op_fmod({}, {})",
    torch.hypot: "op_hypot({}, {})",
    torch.remainder: "op_remainder({}, {})",
}
# The operand count of each function that records; it takes no keyword.
_ARITY = dict.fromkeys(_UNARY, 1)
_ARITY.update(dict.fromkeys(_BINARY, 2))
_ARITY.update({torch.pow: 2, torch.floor_divide: 2, torch.lerp: 3,
               torch.where: 3, torch.logical_and: 2, torch.zeros_like: 1,
               torch.ones_like: 1, torch.full_like: 2})
# The tensor methods that record: each the torch function of its name,
# which takes the tensor as its first operand (so not ``where``).
_METHODS = {f.__name__: f for f in list(_ARITY) + [torch.clamp]
            if f not in (torch.where, torch.zeros_like, torch.ones_like,
                         torch.full_like)}


def _bind(sdf, em):
    """``sdf`` with each parameter leaf replaced by a Rec reading ``P``,
    in ``tree_leaves`` order (the order of ``_flat_params``)."""
    offset = [0]

    def leaf(x):
        a = np.asarray(x, dtype=np.float64)
        idx = offset[0] + np.arange(a.size).reshape(a.shape)
        offset[0] += a.size
        expr = np.vectorize(lambda i: "P[%d]" % i, otypes=[object])(idx)
        return Rec(em, np.asarray(expr, dtype=object))

    return tree_map(leaf, sdf)


def param_count(sdf):
    """The number of parameter values of ``sdf`` (its leaves' sizes)."""
    return sum(int(np.size(x)) for x in tree_leaves(sdf))


def params_in_args(sdf):
    """Whether the kernels take ``sdf``'s parameters by value in their
    arguments (else from device memory): a property of its structure."""
    return param_count(sdf) <= MAX_ARG_PARAMS


def _check_fields(nf):
    if nf > MAX_FIELDS:
        raise ValueError(
            "the eval kernels take at most %d field inputs, the expression "
            "records %d" % (MAX_FIELDS, nf)
        )


def record(sdf, dim=3, dtype=None):
    """Run the expression's own code once on ``Rec`` values at the point
    ``(x, y, z)`` (its first ``dim`` components): ``(emitter, result, the
    number of field inputs its placeholders read)``.  ``dtype`` is the one
    dtype the body will run in (None: both).  Raises ``NoCppForm`` at an
    op the body cannot hold in it."""
    em = _Emitter(dtype)
    node = _bind(sdf, em)
    p = Points(*[Rec(em, n) for n in ("x", "y", "z")[:dim]])
    read = lambda k: Rec(em, em.var("f", "F.p[%d][fi]" % k))
    with hybrid.kernel_fields(read) as fields:
        d = node.fn(node.params, p)
    return em, d, fields.taken


def _source(template, sdf, nf=None, dtype=None):
    """The kernel source ``template`` for ``sdf``'s structure: the shared
    per-point piece ``csrc/sdf_point.cuh`` spliced in at its include line,
    with the recorded body inserted.  The gather-marked subtrees of ``sdf``
    become placeholders (``hybrid.to_kernel_tree``) whose statements read
    the field inputs in evaluation order; ``nf``, when given, is the number
    of fields the caller recorded, and must be the number read.  ``dtype``
    is the one dtype the caller launches (None: a source for both)."""
    _check_fields(nf or 0)
    if hybrid.count_gathers(sdf):
        sdf = hybrid.to_kernel_tree(sdf)
    em, d, taken = record(sdf, dtype=dtype)
    if nf is not None and taken != nf:
        raise ValueError(
            "the expression reads %d field inputs, %d were recorded"
            % (taken, nf)
        )
    _check_fields(taken)
    if isinstance(d, numbers.Number):
        d = Rec(em, _lit(d))
    if not isinstance(d, Rec) or d.shape != () or d.kind != "f":
        raise NotImplementedError("expression did not record to one value")
    body = "\n".join(em.lines + ["  return %s;" % d.expr[()]])
    params = ("#define SDF_NPARAMS %d\n#define SDF_PARAMS_IN_ARGS %d\n"
              "#define SDF_NFIELDS %d" % (param_count(sdf),
                                          params_in_args(sdf), taken))
    point = _build.source("sdf_point.cuh").replace(_BODY_MARK, body).replace(
        _PARAMS_MARK, params)
    return _build.source(template).replace(_POINT_INCLUDE, point)


def kernel_source(sdf, nf=None, dtype=None):
    """The CUDA source of kernel B1 for ``sdf``'s structure, launched in
    ``dtype`` (None: either); a gather-bearing expression's body reads
    its ``nf`` field inputs."""
    return _source("eval_classify.cu", sdf, nf, dtype)


def tile_kernel_source(sdf, nf=None, dtype=None):
    """The CUDA source of kernels B6 and B7 for ``sdf``'s structure,
    launched in ``dtype`` (None: either); a gather-bearing expression's
    body reads its ``nf`` field inputs."""
    return _source("eval_tiles.cu", sdf, nf, dtype)


def _flat_params(sdf, dtype, device):
    return upload([_host_params(sdf)], dtype, device)[0]


def _host_params(sdf):
    leaves = [np.ravel(np.asarray(x, dtype=np.float64))
              for x in tree_leaves(sdf)]
    return np.concatenate(leaves) if leaves else np.zeros(1)


def _params_arg(sdf, dtype, device):
    """What a kernel entry takes as ``P``: the host array of the parameter
    values in ``dtype`` when they travel in the kernel arguments (the entry
    copies them at launch), else the values on ``device``."""
    if params_in_args(sdf):
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        return np.ascontiguousarray(_host_params(sdf).astype(np_dtype))
    return _flat_params(sdf, dtype, device)


def _address(a):
    return a.ctypes.data if isinstance(a, np.ndarray) else a.data_ptr()


# --- the plain pair --------------------------------------------------------------


def _axes(X, Y, Z, dtype, device):
    return upload([np.asarray(a, dtype=np.float64) for a in (X, Y, Z)],
                  dtype, device)


def _eval_volume(sdf, X, Y, Z, dtype, device, fields=()):
    """Dense volume evaluation with torch ops on broadcast ``Points``,
    chunked along x.  X/Y/Z are host float64 axis coordinates; ``fields``
    are the ``(nx, ny, nz)`` tensors that the placeholders of a
    ``hybrid.to_kernel_tree`` read."""
    Xt, Yt, Zt = _axes(X, Y, Z, dtype, device)
    sdf_c = cast(sdf, dtype, device)
    nx, ny, nz = len(Xt), len(Yt), len(Zt)
    vol = torch.empty((nx, ny, nz), dtype=dtype, device=device)
    step = max(1, min(nx, -(-_TARGET_CHUNK_POINTS // (ny * nz))))
    for i in range(0, nx, step):
        xs = Xt[i: i + step]
        p = Points(xs[:, None, None], Yt[None, :, None], Zt[None, None, :])
        with hybrid.kernel_fields(lambda k: fields[k][i: i + step]):
            d = sdf_c(p)
        vol[i: i + step] = torch.as_tensor(d).broadcast_to((len(xs), ny, nz))
    return vol


def _eval_classify_plain(sdf, X, Y, Z, dtype, device, fields=()):
    vol = _eval_volume(sdf, X, Y, Z, dtype, device, fields)
    return vol, _cell_cases(vol)


# --- kernel B1 -----------------------------------------------------------------


# Kernel B1's launch plan (csrc/eval_classify.cu): a block owns a patch of
# (_PY - 1) x (_PZ - 1) cells in y and z, and a slab of SLAB cell planes
# along x.  Measured on the H100 (chip_smoke.py --slab-sweep), 16 planes
# are within 2% of the fastest length at 162^3 and within 5% at 407^3,
# where longer slabs win; one length keeps every grid of 2^22 samples and
# up at <= 1.17 evaluations a sample.
_PZ, _PY = 32, 16
SLAB = 16


def slab_plan(nx, ny, nz, lx=SLAB):
    """Kernel B1's grid of blocks for an ``nx x ny x nz`` sample grid with
    slabs of ``lx`` cell planes: ``(gz, gy, gx)``, the z patches, the y
    patches and the x slabs."""
    return (-(-(nz - 1) // (_PZ - 1)), -(-(ny - 1) // (_PY - 1)),
            -(-(nx - 1) // lx))


def slab_evaluations(nx, ny, nz, lx=SLAB):
    """Samples kernel B1 evaluates with slabs of ``lx`` cell planes (halos
    included).  The plan is separable: per axis, each block evaluates its
    cells' samples plus one, as far as the grid reaches."""

    def axis(n, cells):
        return sum(min(cells + 1, n - a) for a in range(0, n - 1, cells))

    return axis(nx, lx) * axis(ny, _PY - 1) * axis(nz, _PZ - 1)


# Kernel B1's and the bounds probe's entries, by tree (held weakly) and
# then by (field count, dtype): the bounds probe and every B1 launch on the
# same tree, the call's dense launch among them, resolve its library once.
_ENTRIES = weakref.WeakKeyDictionary()


def _entries(sdf, nf, dtype):
    """Kernel B1's and the bounds probe's entries in the library of
    ``sdf``'s structure with ``nf`` fields, in ``dtype``: the source
    generated and the library found under the ``kernel_source`` span,
    counting one source, on the first call for the tree ``sdf``; later
    calls for it take them from ``_ENTRIES``, with no span."""
    per = _ENTRIES.setdefault(sdf, {})
    hit = per.get((nf, dtype))
    if hit is not None:
        return hit
    suffix = "f32" if dtype == torch.float32 else "f64"
    vp, i = ctypes.c_void_p, ctypes.c_int
    with spans.span("kernel_source"):
        spans.count("kernel_sources")
        lib = _build.load("eval_classify", kernel_source(sdf, nf, dtype))
        b1 = getattr(lib, "sdf_eval_classify_" + suffix)
        b1.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp, vp,
                       vp]
        b1.restype = ctypes.c_int
        probe = getattr(lib, "sdf_bounds_probe_" + suffix)
        probe.argtypes = [vp, vp, vp, vp, i, i, i, vp, vp]
        probe.restype = ctypes.c_int
    per[(nf, dtype)] = (b1, probe)
    return b1, probe


def _launch(sdf, X, Y, Z, dtype, device, lx=SLAB, fields=()):
    """Kernel B1 on ``sdf`` (a ``hybrid.to_kernel_tree`` reading
    ``fields`` when they are given); adds one to
    ``eval_and_classify.launches`` when it launches."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError("eval_and_classify: dtype must be float32 or float64")
    nx, ny, nz = len(X), len(Y), len(Z)
    if min(nx, ny, nz) < 2:
        raise ValueError("eval_and_classify: every axis needs >= 2 samples")
    vol = torch.empty((nx, ny, nz), dtype=dtype, device=device)
    for f in fields:
        _build.require_cuda(f, "eval_and_classify field")
        if f.shape != vol.shape or f.dtype != dtype or f.device != vol.device:
            raise ValueError(
                "eval_and_classify: a field must be %s of shape %s on %s"
                % (dtype, tuple(vol.shape), vol.device))
    fn, _ = _entries(sdf, len(fields), dtype)
    vp = ctypes.c_void_p
    Xt, Yt, Zt = _axes(X, Y, Z, dtype, device)
    P = _params_arg(sdf, dtype, device)
    ptrs = (vp * max(1, len(fields)))(*[f.data_ptr() for f in fields])
    case = torch.empty((nx - 1, ny - 1, nz - 1), dtype=torch.int32,
                       device=device)
    gz, gy, gx = slab_plan(nx, ny, nz, lx)
    _build.check(
        fn(Xt.data_ptr(), Yt.data_ptr(), Zt.data_ptr(), _address(P), ptrs,
           len(fields), nx, ny, nz, lx, gz, gy, gx, vol.data_ptr(),
           case.data_ptr(), _build.stream_ptr(vol.device)),
        "eval_classify",
    )
    eval_and_classify.launches += 1
    return vol, case


def record_fields(sdf, X, Y, Z, dtype, device):
    """Kernel B1's pre-pass: the fields of the gather-bearing subtrees of
    the uncast expression ``sdf`` over the whole grid ``X x Y x Z``, on
    ``device`` (``()`` for a gather-free expression)."""
    if not hybrid.count_gathers(sdf):
        return ()
    return hybrid.record_dense(sdf, *_axes(X, Y, Z, dtype, device))


def eval_and_classify(sdf, X, Y, Z, dtype, device, fields=None):
    """Evaluate + classify the dense grid ``X x Y x Z`` (host float64 axis
    coordinates) for the uncast expression ``sdf`` in ``dtype``.  Returns
    ``(vol (nx, ny, nz), case (nx-1, ny-1, nz-1) int32)`` on ``device``:
    kernel B1 on CUDA, the plain pair on the CPU.  The fields of
    gather-bearing subtrees are ``fields`` when given (``record_fields``
    of the same call), else recorded here."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError("eval_and_classify: unsupported device %s" % device)
    tree = sdf
    if hybrid.count_gathers(sdf):
        if fields is None:
            fields = record_fields(sdf, X, Y, Z, dtype, device)
        _check_fields(len(fields))
        tree = hybrid.to_kernel_tree(sdf)
    fields = tuple(fields or ())
    if device.type == "cpu":
        return _eval_classify_plain(tree, X, Y, Z, dtype, device, fields)
    return _launch(tree, X, Y, Z, dtype, device, fields=fields)


eval_and_classify.launches = 0


# The most samples an axis of the bounds probe's grid (csrc/eval_classify.cu
# PROBE_AXIS): the axes travel by value in the kernel's arguments.
PROBE_AXIS = 16


def bounds_probe(sdf, dtype, device):
    """The card's evaluator of the bounds refinement's rounds
    (``engine._estimate_bounds_host``) for the uncast gather-free
    expression ``sdf`` in ``dtype`` on the CUDA ``device``: a function from
    three host float64 axes (at most ``PROBE_AXIS`` values each) to the
    values of their grid, as a float64 numpy volume.  Each call is one
    launch of the probe kernel in kernel B1's library
    (``csrc/eval_classify.cu``), which adds one to
    ``bounds_probe.launches``, and one ``node.fetch``.  The library, its
    entry and the parameters are resolved here, once (``_entries``, which
    B1's launches on ``sdf`` share).  Its plain pair is the
    engine's CPU evaluator.  Raises ``NoCppForm`` (a
    ``NotImplementedError``) where the expression records no body."""
    if torch.device(device).type != "cuda":
        raise ValueError("bounds_probe: the device must be CUDA")
    if hybrid.count_gathers(sdf):
        raise ValueError("bounds_probe: the expression has gather-marked "
                         "subtrees")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError("bounds_probe: dtype must be float32 or float64")
    _, fn = _entries(sdf, 0, dtype)
    P = _params_arg(sdf, dtype, device)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    stream = _build.stream_ptr(device)

    def probe(X, Y, Z):
        axes = [np.asarray(a, np.float64).astype(np_dtype)
                for a in (X, Y, Z)]
        shape = tuple(len(a) for a in axes)
        if not all(1 <= n <= PROBE_AXIS for n in shape):
            raise ValueError("bounds_probe: each axis takes 1 to %d values"
                             % PROBE_AXIS)
        out = torch.empty(shape, dtype=dtype, device=device)
        _build.check(
            fn(*[a.ctypes.data for a in axes], _address(P), *shape,
               out.data_ptr(), stream),
            "bounds_probe",
        )
        bounds_probe.launches += 1
        return fetch([out])[0].astype(np.float64)

    return probe


bounds_probe.launches = 0



# --- the tiled sparse path: kernels B6 and B7 ----------------------------------


def _eval_tiles(sdf, X, Y, Z, tiles, tile, dtype, chunk=128, clamp=True,
                fields=()):
    """Plain version of kernels B6 and B7: the ``(ntc, TS, TS, TS)`` tile
    volumes of the uncast expression ``sdf`` with the torch ops of
    ``_eval_volume``, ``chunk`` tiles at a time.

    ``tiles`` is an ``(ntc, 3)`` int32 tensor of tile indices on the device
    to evaluate on (padded rows repeat tile 0 and are masked downstream).
    With ``clamp`` the sample indices ``t * tile + [0, tile]`` are clipped
    to the grid (the repeated boundary samples belong to cells masked as
    out of grid); without it the caller has padded the host axes X/Y/Z by
    ``tile`` samples.  ``fields`` are the tensors that the placeholders of
    a ``hybrid.to_kernel_tree`` read, each ``(ntc, TS, TS, TS)``."""
    device = tiles.device
    Xt, Yt, Zt = _axes(X, Y, Z, dtype, device)
    sdf_c = cast(sdf, dtype, device)
    ntc, TS = tiles.shape[0], tile + 1
    ar = torch.arange(TS, device=device)
    vols = torch.empty((ntc, TS, TS, TS), dtype=dtype, device=device)
    for i in range(0, ntc, max(1, chunk)):
        t = tiles[i: i + chunk].to(torch.int64)

        def window(axis, col):
            idx = t[:, col: col + 1] * tile + ar
            if clamp:
                idx = idx.clamp(0, axis.numel() - 1)
            return axis[idx]  # (chunk, TS)

        p = Points(window(Xt, 0)[:, :, None, None],
                   window(Yt, 1)[:, None, :, None],
                   window(Zt, 2)[:, None, None, :])
        with hybrid.kernel_fields(lambda k: fields[k][i: i + chunk]):
            d = sdf_c(p)
        vols[i: i + chunk] = torch.as_tensor(d).broadcast_to(
            (len(t), TS, TS, TS))
    return vols


# Kernels B6 and B7's launch plan (csrc/eval_tiles.cu): a tile row's
# samples, flattened, are cut into ``blocks`` ranges of S samples (a
# multiple of 32), one block each; the blocks of a row form clusters of
# ``csize`` and take the halo their cells read from the next block's
# shared memory, so only a cluster's last block, when the row goes on past
# it, evaluates its halo (tile 243 and up).  A row takes as many blocks as
# fill the card's SMs at _TILE_BLOCKS_PER_SM each (4 blocks of 256
# threads, what bodies of up to 64 registers allow) with the launch's rows,
# at most a cluster's _TILE_CLUSTER and each of at least _TILE_BLOCK_MIN
# samples (and more than a halo).  Blobby's 388 evaluated rows at 2^26,
# tile 32, on 132 SMs: 2 blocks a row of 17,984 samples, 776 blocks, each
# sample evaluated once.  Measured on the H100 (chip_smoke.py
# --tile-sweep), 2 blocks a row are 1-6% faster there than 1, 4 or 8
# (float32 0.390 ms against 0.405, 0.415 and 0.409), and 8 blocks that
# each evaluate their halo again (1.22 evaluations a sample) 15% slower.
_TILE_THREADS = 256
_TILE_CLUSTER = 8
_TILE_BLOCK_MIN = 2048
_TILE_BLOCKS_PER_SM = 4
_TILE_SMEM = 232448  # bytes of shared memory a block may take


def _tile_words(S, TS):
    """32-bit words of sign bits a block of S samples keeps: its own and
    the halo its cells read, to the second word of the last pair read."""
    return (S - 1 + TS * TS + TS) // 32 + 2


def tile_plan(tile, rows, sms, blocks=None, csize=None):
    """Kernels B6/B7's plan at ``tile`` cells a tile for a launch over
    ``rows`` rows on a card of ``sms`` SMs: ``(S, blocks, csize, smem)``,
    the samples of a block's range, the blocks of a row, the blocks of a
    cluster and the bytes of shared memory a block takes.  ``blocks`` and
    ``csize`` force another cut (the card tests, the sweep)."""
    if tile < 1:
        raise ValueError("tile_plan: tile must be >= 1")
    TS = tile + 1
    N, halo = TS ** 3, TS * TS + TS + 1
    if blocks is None:
        fill = sms * _TILE_BLOCKS_PER_SM
        csize = max(1, min(_TILE_CLUSTER, -(-fill // max(rows, 1)),
                           N // max(_TILE_BLOCK_MIN, halo + 64)))
        blocks = csize
        while (4 * _tile_words(-(-N // (32 * blocks)) * 32, TS) > _TILE_SMEM
               and N // blocks > halo):
            blocks += csize
    csize = csize or 1
    S = -(-N // (32 * blocks)) * 32
    smem = 4 * _tile_words(S, TS)
    if (blocks % csize or not 1 <= csize <= _TILE_CLUSTER
            or smem > _TILE_SMEM
            or (csize > 1 and S < (_tile_words(S, TS) - S // 32) * 32)):
        raise ValueError("tile_plan: no plan of %s blocks in clusters of %s "
                         "at tile %d" % (blocks, csize, tile))
    return S, blocks, csize, smem


def tile_evaluations(tile, rows, sms, blocks=None, csize=None):
    """Samples kernels B6/B7 evaluate for one tile row: each once, and the
    halo of each cluster's last block where the row goes on past it."""
    S, blocks, csize, _ = tile_plan(tile, rows, sms, blocks, csize)
    TS = tile + 1
    N, halo = TS ** 3, TS * TS + TS + 1
    extra = sum(min(s1 + halo, N) - s1
                for s1 in (min((b + 1) * S, N)
                           for b in range(csize - 1, blocks, csize)))
    return N + extra


def _rows_evaluated(ntc, live):
    """Rows of a tile list that kernels B6/B7 evaluate: every row, or with
    ``live`` the live rows and the first padded one, which every later row
    repeats."""
    if live is None:
        return ntc
    if not 0 <= live <= ntc:
        raise ValueError("eval_tiles: live must be in [0, %d]" % ntc)
    return min(live + 1, ntc)


def _repeat_last_row(vols, case, rows):
    """Fill rows ``rows..`` of the outputs with a copy of row ``rows - 1``
    (the padded rows a ``live`` call does not evaluate)."""
    if 0 < rows < vols.shape[0]:
        vols[rows:] = vols[rows - 1]
        case[rows:] = case[rows - 1]
    return vols, case


def _plain_tiles(sdf, X, Y, Z, tiles, tile, dtype, live, clamp=True,
                 fields=()):
    """The plain pair on the rows a ``live`` call evaluates, the padded
    rows copied as the kernel's wrapper copies them."""
    ntc = tiles.shape[0]
    rows = _rows_evaluated(ntc, live)
    vols = torch.empty((ntc,) + (tile + 1,) * 3, dtype=dtype,
                       device=tiles.device)
    vols[:rows] = _eval_tiles(sdf, X, Y, Z, tiles[:rows], tile, dtype,
                              clamp=clamp, fields=fields)
    case = torch.empty((ntc,) + (tile,) * 3, dtype=torch.int32,
                       device=tiles.device)
    case[:rows] = _cell_cases(vols[:rows])
    return _repeat_last_row(vols, case, rows)


def _launch_tiles(sdf, X, Y, Z, tiles, tile, dtype, live, fields, counter,
                  blocks=None, csize=None):
    """Kernel B6 or B7 on the rows ``live`` leaves to evaluate, under
    ``tile_plan`` for those rows (or with ``blocks`` and ``csize`` forced);
    the padded rows are copies.  Adds one to ``counter.launches``, the
    calling wrapper's."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError("eval_tiles: dtype must be float32 or float64")
    _build.require_cuda(tiles, "eval_tiles")
    ntc, TS = tiles.shape[0], tile + 1
    rows = _rows_evaluated(ntc, live)
    vols = torch.empty((ntc, TS, TS, TS), dtype=dtype, device=tiles.device)
    case = torch.empty((ntc, tile, tile, tile), dtype=torch.int32,
                       device=tiles.device)
    for f in fields:
        _build.require_cuda(f, "eval_tiles field")
        if (f.shape != (rows,) + vols.shape[1:] or f.dtype != dtype
                or f.device != tiles.device):
            raise ValueError(
                "eval_tiles: a field must be %s of shape %s on the tiles' "
                "device" % (dtype, (rows,) + tuple(vols.shape[1:])))
    if ntc == 0:
        return vols, case
    sms = torch.cuda.get_device_properties(tiles.device).multi_processor_count
    S, blocks, csize, _ = tile_plan(tile, rows, sms, blocks, csize)
    with spans.span("kernel_source"):
        spans.count("kernel_sources")
        lib = _build.load("eval_tiles", tile_kernel_source(sdf, len(fields),
                                                           dtype))
        fn = getattr(lib, "sdf_eval_tiles_%s%s" % (
            "fields_" if fields else "",
            "f32" if dtype == torch.float32 else "f64"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int64, i, i, i, i, i, i,
                       i, vp, i, vp, vp, vp]
        fn.restype = ctypes.c_int
    Xt, Yt, Zt = _axes(X, Y, Z, dtype, tiles.device)
    P = _params_arg(sdf, dtype, tiles.device)
    ptrs = (vp * max(1, len(fields)))(*[f.data_ptr() for f in fields])
    _build.check(
        fn(Xt.data_ptr(), Yt.data_ptr(), Zt.data_ptr(), _address(P),
           tiles.data_ptr(), rows, len(X), len(Y), len(Z), tile, S, blocks,
           csize, ptrs, len(fields), vols.data_ptr(), case.data_ptr(),
           _build.stream_ptr(tiles.device)),
        "eval_tiles",
    )
    counter.launches += 1
    return _repeat_last_row(vols, case, rows)


def _check_tiles(tiles, tile, what):
    if (tiles.dtype != torch.int32 or tiles.dim() != 2 or tiles.shape[1] != 3
            or tile < 1):
        raise ValueError("%s: tiles must be (ntc, 3) int32, tile >= 1" % what)
    if tiles.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (what, tiles.device))


def eval_tiles_and_classify_batched(sdf, X, Y, Z, tiles, tile, dtype,
                                    live=None):
    """Evaluate + classify the tiles ``tiles`` ((ntc, 3) int32 tensor; its
    device is where the work runs) of the grid ``X x Y x Z`` (host float64
    axis coordinates, UNPADDED: sample indices clamp to the grid) for the
    uncast gather-free expression ``sdf`` in ``dtype``.  Returns ``(vols
    (ntc, TS, TS, TS), case (ntc, tile, tile, tile) int32)``: kernel B6 on
    CUDA, the plain pair on the CPU.

    ``live``, when given, promises that rows ``live..ntc-1`` all equal row
    ``live`` (a list padded with one tile): only rows ``[0, min(live + 1,
    ntc))`` are evaluated and the later ones are copies of the last, so the
    outputs equal those of ``live=None``."""
    _check_tiles(tiles, tile, "eval_tiles_and_classify_batched")
    if hybrid.count_gathers(sdf):
        raise ValueError(
            "eval_tiles_and_classify_batched: the expression has "
            "gather-marked subtrees; use eval_tiles_and_classify")
    if tiles.device.type == "cpu":
        return _plain_tiles(sdf, X, Y, Z, tiles, tile, dtype, live)
    return _launch_tiles(sdf, X, Y, Z, tiles, tile, dtype, live, (),
                         eval_tiles_and_classify_batched)


eval_tiles_and_classify_batched.launches = 0


def eval_tiles_and_classify(sdf, X, Y, Z, tiles, tile, dtype, live=None):
    """The contract of ``eval_tiles_and_classify_batched`` on axes PADDED
    by the caller with ``tile`` copies of their last coordinate, for any
    expression: the fields of its gather-marked subtrees are computed ahead
    with torch ops on the windows of the rows ``live`` leaves to evaluate
    (``hybrid.record_tiles``) and read by the kernel.  Kernel B7 on CUDA,
    the plain pair on the CPU."""
    _check_tiles(tiles, tile, "eval_tiles_and_classify")
    fields, tree = (), sdf
    if hybrid.count_gathers(sdf):
        axes = _axes(X, Y, Z, dtype, tiles.device)
        fields = hybrid.record_tiles(
            sdf, *axes, tiles[:_rows_evaluated(tiles.shape[0], live)], tile)
        tree = hybrid.to_kernel_tree(sdf)
    if tiles.device.type == "cpu":
        return _plain_tiles(tree, X, Y, Z, tiles, tile, dtype, live,
                            clamp=False, fields=fields)
    return _launch_tiles(tree, X, Y, Z, tiles, tile, dtype, live, fields,
                         eval_tiles_and_classify)


eval_tiles_and_classify.launches = 0
