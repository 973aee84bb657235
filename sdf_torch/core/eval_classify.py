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
``chip_smoke.py`` holds the kernel against.

``eval_tiles_and_classify_batched`` (kernel B6) and
``eval_tiles_and_classify`` (kernel B7) do the same for a list of tiles,
each a ``(tile+1)^3`` sample cube: B6 on the unpadded axes with indices
clamped to the grid, for expressions the body can hold whole; B7 on axes
padded by one tile, with the fields of gather-bearing subtrees computed
ahead by ``core.hybrid`` and read by the body.  Both are instantiations of
the kernel template ``csrc/eval_tiles.cu`` and share B1's per-point body
(``csrc/sdf_point.cuh``).  Their plain pair is ``_eval_tiles`` +
``mc._cell_cases``.

Ops with no C++ form raise ``NotImplementedError`` naming the op on the
card.
"""

from __future__ import annotations

import ctypes
import math
import numbers

import numpy as np
import torch

from .. import _build
from . import hybrid
from .mc import _cell_cases
from .node import Points, cast, tree_leaves, tree_map, upload

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
    """Collects the generated body: one ``const`` statement per op."""

    def __init__(self):
        self.lines = []

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
        fmt = {2: "({0} * {0})", 3: "({0} * {0} * {0})",
               0.5: "op_sqrt({0})", -1: "(T(1) / {0})",
               -2: "(T(1) / ({0} * {0}))"}.get(o)
        if fmt is not None:
            return self._map(fmt, (self,), "f")
        return self._map("op_pow({}, {})", (self, o), "f")

    def __rpow__(self, o):
        if o == 2:
            return self._map("op_exp2({})", (self,), "f")
        return self._map("op_pow({}, {})", (o, self), "f")

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

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = next(a for a in list(args) + list(kwargs.values())
                   if isinstance(a, Rec))
        if func in _UNARY:
            return rec._map(_UNARY[func], (args[0],), "f")
        if func in _BINARY:
            return rec._map(_BINARY[func], args[:2], "f")
        if func is torch.where:
            c, a, b = args
            return rec._map("({} ? {} : {})", (c, a, b), "f")
        if func is torch.logical_and:
            return rec._map("({} && {})", args[:2], "b")
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
        name = getattr(func, "__name__", repr(func))
        raise NotImplementedError(
            "op %r has no C++ form in the CUDA eval kernel" % name
        )


_UNARY = {
    torch.abs: "op_abs({})",
    torch.sqrt: "op_sqrt({})",
    torch.cos: "op_cos({})",
    torch.sin: "op_sin({})",
    torch.round: "op_round({})",
    torch.sign: "op_sign({})",
    torch.neg: "(-{})",
}
_BINARY = {
    torch.minimum: "op_min({}, {})",
    torch.maximum: "op_max({}, {})",
    torch.atan2: "op_atan2({}, {})",
    torch.fmod: "op_fmod({}, {})",
}


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


def _source(template, sdf, nf=None):
    """The kernel source ``template`` for ``sdf``'s structure: the shared
    per-point piece ``csrc/sdf_point.cuh`` spliced in at its include line,
    with the recorded body inserted.  The gather-marked subtrees of ``sdf``
    become placeholders (``hybrid.to_kernel_tree``) whose statements read
    the field inputs in evaluation order; ``nf``, when given, is the number
    of fields the caller recorded, and must be the number read."""
    _check_fields(nf or 0)
    if hybrid.count_gathers(sdf):
        sdf = hybrid.to_kernel_tree(sdf)
    em = _Emitter()
    node = _bind(sdf, em)
    p = Points(*[Rec(em, n) for n in ("x", "y", "z")])
    read = lambda k: Rec(em, em.var("f", "F.p[%d][fi]" % k))
    with hybrid.kernel_fields(read) as fields:
        d = node.fn(node.params, p)
    if nf is not None and fields.taken != nf:
        raise ValueError(
            "the expression reads %d field inputs, %d were recorded"
            % (fields.taken, nf)
        )
    _check_fields(fields.taken)
    if isinstance(d, numbers.Number):
        d = Rec(em, _lit(d))
    if not isinstance(d, Rec) or d.shape != () or d.kind != "f":
        raise NotImplementedError("expression did not record to one value")
    body = "\n".join(em.lines + ["  return %s;" % d.expr[()]])
    params = ("#define SDF_NPARAMS %d\n#define SDF_PARAMS_IN_ARGS %d\n"
              "#define SDF_NFIELDS %d" % (param_count(sdf),
                                          params_in_args(sdf), fields.taken))
    point = _build.source("sdf_point.cuh").replace(_BODY_MARK, body).replace(
        _PARAMS_MARK, params)
    return _build.source(template).replace(_POINT_INCLUDE, point)


def kernel_source(sdf, nf=None):
    """The CUDA source of kernel B1 for ``sdf``'s structure; a
    gather-bearing expression's body reads its ``nf`` field inputs."""
    return _source("eval_classify.cu", sdf, nf)


def tile_kernel_source(sdf, nf=None):
    """The CUDA source of kernels B6 and B7 for ``sdf``'s structure; a
    gather-bearing expression's body reads its ``nf`` field inputs."""
    return _source("eval_tiles.cu", sdf, nf)


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
    lib = _build.load("eval_classify", kernel_source(sdf, len(fields)))
    fn = getattr(lib, "sdf_eval_classify_"
                 + ("f32" if dtype == torch.float32 else "f64"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp, vp, vp]
    fn.restype = ctypes.c_int
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


def _launch_tiles(sdf, X, Y, Z, tiles, tile, dtype, clamp, fields, counter):
    if dtype not in (torch.float32, torch.float64):
        raise ValueError("eval_tiles: dtype must be float32 or float64")
    _build.require_cuda(tiles, "eval_tiles")
    ntc, TS = tiles.shape[0], tile + 1
    vols = torch.empty((ntc, TS, TS, TS), dtype=dtype, device=tiles.device)
    case = torch.empty((ntc, tile, tile, tile), dtype=torch.int32,
                       device=tiles.device)
    for f in fields:
        _build.require_cuda(f, "eval_tiles field")
        if f.shape != vols.shape or f.dtype != dtype or f.device != tiles.device:
            raise ValueError(
                "eval_tiles: a field must be %s of shape %s on the tiles' "
                "device" % (dtype, tuple(vols.shape)))
    if ntc == 0:
        return vols, case
    src = tile_kernel_source(sdf, len(fields))
    lib = _build.load("eval_tiles", src)
    name = "sdf_eval_tiles_%s%s" % (
        "" if clamp else "fields_", "f32" if dtype == torch.float32 else "f64")
    fn = getattr(lib, name)
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int64, i, i, i, i, vp, i, vp,
                   vp, vp]
    fn.restype = ctypes.c_int
    Xt, Yt, Zt = _axes(X, Y, Z, dtype, tiles.device)
    P = _params_arg(sdf, dtype, tiles.device)
    ptrs = (vp * max(1, len(fields)))(*[f.data_ptr() for f in fields])
    _build.check(
        fn(Xt.data_ptr(), Yt.data_ptr(), Zt.data_ptr(), _address(P),
           tiles.data_ptr(), ntc, len(X), len(Y), len(Z), tile, ptrs,
           len(fields), vols.data_ptr(), case.data_ptr(),
           _build.stream_ptr(tiles.device)),
        "eval_tiles",
    )
    counter.launches += 1
    return vols, case


def _check_tiles(tiles, tile, what):
    if (tiles.dtype != torch.int32 or tiles.dim() != 2 or tiles.shape[1] != 3
            or tile < 1):
        raise ValueError("%s: tiles must be (ntc, 3) int32, tile >= 1" % what)
    if tiles.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (what, tiles.device))


def eval_tiles_and_classify_batched(sdf, X, Y, Z, tiles, tile, dtype):
    """Evaluate + classify the tiles ``tiles`` ((ntc, 3) int32 tensor; its
    device is where the work runs) of the grid ``X x Y x Z`` (host float64
    axis coordinates, UNPADDED: sample indices clamp to the grid) for the
    uncast gather-free expression ``sdf`` in ``dtype``.  Returns ``(vols
    (ntc, TS, TS, TS), case (ntc, tile, tile, tile) int32)``: kernel B6 on
    CUDA, the plain pair on the CPU."""
    _check_tiles(tiles, tile, "eval_tiles_and_classify_batched")
    if hybrid.count_gathers(sdf):
        raise ValueError(
            "eval_tiles_and_classify_batched: the expression has "
            "gather-marked subtrees; use eval_tiles_and_classify")
    if tiles.device.type == "cpu":
        vols = _eval_tiles(sdf, X, Y, Z, tiles, tile, dtype)
        return vols, _cell_cases(vols)
    return _launch_tiles(sdf, X, Y, Z, tiles, tile, dtype, True, (),
                         eval_tiles_and_classify_batched)


eval_tiles_and_classify_batched.launches = 0


def eval_tiles_and_classify(sdf, X, Y, Z, tiles, tile, dtype):
    """The contract of ``eval_tiles_and_classify_batched`` on axes PADDED
    by the caller with ``tile`` copies of their last coordinate (no clamp),
    for any expression: the fields of its gather-marked subtrees are
    computed ahead with torch ops on the tiles' windows
    (``hybrid.record_tiles``) and read by the kernel.  Kernel B7 on CUDA,
    the plain pair on the CPU."""
    _check_tiles(tiles, tile, "eval_tiles_and_classify")
    fields, tree = (), sdf
    if hybrid.count_gathers(sdf):
        axes = _axes(X, Y, Z, dtype, tiles.device)
        fields = hybrid.record_tiles(sdf, *axes, tiles, tile)
        tree = hybrid.to_kernel_tree(sdf)
    if tiles.device.type == "cpu":
        vols = _eval_tiles(tree, X, Y, Z, tiles, tile, dtype, clamp=False,
                           fields=fields)
        return vols, _cell_cases(vols)
    return _launch_tiles(tree, X, Y, Z, tiles, tile, dtype, False, fields,
                         eval_tiles_and_classify)


eval_tiles_and_classify.launches = 0
