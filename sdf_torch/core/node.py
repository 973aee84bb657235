"""Expression-tree core: SDF nodes whose parameters are torch tensors.

The counterpart of ``sdf_tpu.core.node``.  A node carries

  * ``fn``     -- a pure evaluation function ``fn(params, p) -> d``
  * ``params`` -- a nested dict/list of numeric parameters, which may hold
                  child SDF nodes (the CSG tree *is* the parameter tree)
  * ``_k``     -- the optional smooth-blend radius tag

Parameters are float64 numpy arrays at construction; ``cast`` copies the
tree with every leaf turned into a tensor of the compute dtype on an
explicit device, just before evaluation.  The leaf order of ``tree_leaves``
is the JAX package's pytree flatten order (dict keys sorted, ``None``
holding no leaf, a node's ``params`` before its ``_k``), so
``load_leaves`` can carry the parameters of an ``sdf_tpu`` expression
across to the same expression built here.

Evaluation is structure-of-arrays: a ``Points`` holds one broadcastable
tensor per component.  The public ``(N, dim) -> (N, 1)`` contract lives
at ``_Node.__call__``.  The same ``fn`` code also runs on the symbolic
recorder of ``core.eval_classify`` to generate the CUDA kernel's body, so
ops use plain torch functions and Python operators only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import spans


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else ()


class Points:
    """Structure-of-arrays point batch: one tensor per coordinate component,
    mutually broadcastable (the grid engine passes ``(nx,1,1), (1,ny,1),
    (1,1,nz)`` views, so coordinates are never materialized)."""

    __slots__ = ("c",)

    # numpy arrays defer binary ops to Points (``vec - points`` reaches
    # __rsub__ instead of an elementwise object broadcast).
    __array_ufunc__ = None
    __array_priority__ = 1000

    def __init__(self, *c):
        self.c = tuple(c)

    @property
    def dim(self):
        return len(self.c)

    @property
    def bshape(self):
        return torch.broadcast_shapes(*[_shape(x) for x in self.c])

    @classmethod
    def from_array(cls, p):
        return cls(*[p[..., i] for i in range(p.shape[-1])])

    def __getitem__(self, key):
        if isinstance(key, tuple) and len(key) == 2:
            key = key[1]
        if isinstance(key, slice):
            return Points(*self.c[key])
        return self.c[key]

    def __iter__(self):
        return iter(self.c)

    def _coerce(self, other):
        """Other as a per-component sequence: Points, (dim,) vector, scalar
        (see sdf_tpu.core.node.Points._coerce for the N == dim caveat)."""
        if isinstance(other, Points):
            return other.c
        shape = _shape(other)
        if len(shape) == 1 and shape[0] == self.dim:
            return tuple(other[i] for i in range(self.dim))
        return (other,) * self.dim

    def _bin(self, other, op):
        oc = self._coerce(other)
        return Points(*[op(a, b) for a, b in zip(self.c, oc)])

    def __add__(self, o):
        return self._bin(o, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._bin(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._bin(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin(o, lambda a, b: a / b)

    def __neg__(self):
        return Points(*[-a for a in self.c])

    def __abs__(self):
        from ..ops.vecmath import _abs

        return Points(*[_abs(a) for a in self.c])

    def hmax(self):
        return functools.reduce(torch.maximum, self.c)

    def hmin(self):
        return functools.reduce(torch.minimum, self.c)

    def hsum(self):
        return functools.reduce(lambda a, b: a + b, self.c)


def pointwise(fn):
    """Lift a torch elementwise function over Points (or pass tensors
    through)."""

    def apply(x, *args, **kwargs):
        if isinstance(x, Points):
            return Points(*[fn(c, *args, **kwargs) for c in x.c])
        return fn(x, *args, **kwargs)

    return apply


def as_param(value, dtype=np.float64):
    """A user-supplied numeric parameter as a float64 numpy leaf; ``cast``
    turns leaves into tensors of the compute dtype."""
    return np.asarray(value, dtype=dtype)


# --- the parameter tree ----------------------------------------------------


def tree_leaves(tree):
    """Leaves in the JAX package's pytree flatten order."""
    out = []

    def walk(t):
        if t is None:
            return
        if isinstance(t, _Node):
            walk(t.params)
            walk(t._k)
        elif isinstance(t, dict):
            for key in sorted(t):
                walk(t[key])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        else:
            out.append(t)

    walk(tree)
    return out


def tree_map(fn, tree):
    """Copy of ``tree`` with every leaf replaced by ``fn(leaf)``, visited in
    ``tree_leaves`` order."""
    if tree is None:
        return None
    if isinstance(tree, _Node):
        obj = object.__new__(type(tree))
        obj.fn = tree.fn
        obj.params = tree_map(fn, tree.params)
        obj._k = tree_map(fn, tree._k)
        return obj
    if isinstance(tree, dict):
        mapped = {key: tree_map(fn, tree[key]) for key in sorted(tree)}
        return {key: mapped[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


def resolve_device(device):
    """``None`` means ``"cuda"``; a CUDA device without a card raises (no
    quiet fall back to the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return device


def upload(arrays, dtype, device):
    """Host arrays as ``dtype`` tensors on ``device``.  On a CUDA device all
    of them travel in one copy from pinned memory that does not wait for
    the host (a plain ``torch.as_tensor`` copy synchronizes)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
                for a in arrays]
    # (np.ascontiguousarray makes a 0-d array 1-d: keep each array's shape.)
    host = [torch.from_numpy(np.ascontiguousarray(a)).to(dtype).reshape(
        np.shape(a)) for a in arrays]
    if not host:
        return []
    flat = torch.cat([h.reshape(-1) for h in host]).pin_memory()
    flat = flat.to(device, non_blocking=True)
    out, at = [], 0
    for h in host:
        out.append(flat[at: at + h.numel()].view(h.shape))
        at += h.numel()
    return out


def fetch(tensors):
    """Tensors of any dtypes on one device -> numpy arrays of the same
    shapes, in ONE device-to-host transfer (each ``.cpu()`` waits for the
    card once): the tensors travel as bytes, each padded to 8.  Counts one
    ``host_waits`` of the open ``generate()`` call; under ``engine.PROFILE``
    on a card, the wait for the card is a ``wait`` span of its own, split
    from the copy by a CUDA event recorded just before it (the pageable
    copy would wait for the same work)."""
    parts, metas = [], []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = (-b.numel()) % 8
        if pad:
            b = torch.cat([b, b.new_zeros(pad)])
        parts.append(b)
        metas.append((b.numel(), t.numel() * t.element_size(), t))
    spans.count("host_waits")
    # One tensor on the card needs no concatenation: its .cpu() copies.
    flat = (parts[0] if len(parts) == 1 and parts[0].is_cuda
            else torch.cat(parts))
    if flat.is_cuda and spans.profiling():
        queued = torch.cuda.Event()
        queued.record(torch.cuda.current_stream(flat.device))
        with spans.span("wait"):
            queued.synchronize()
    flat = flat.cpu().numpy()
    out, at = [], 0
    for padded, nbytes, t in metas:
        dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(flat[at: at + nbytes].view(dt).reshape(tuple(t.shape)))
        at += padded
    return out


def fetch_mesh(tensors, nmesh, device, since, prefix="", profile=False):
    """``fetch(tensors)``, the mesh readback of the dense path (``prefix``
    "") or of the tiles (``"tiles_"``), under the span ``<prefix>d2h``.
    Under ``profile`` (``engine.PROFILE``, ``sparse.PROFILE``) the card is
    first fenced (``spans.fence``), so that ``<prefix>d2h`` times the
    transfer and not residual device work, and the call's stats get
    ``<prefix>device``, the seconds from ``since`` (a ``spans.clock()``
    reading) to the fence's end, and ``<prefix>d2h_bytes``, the bytes of
    the first ``nmesh`` arrays (the mesh, not the statistics riding along).
    The dense path's ``d2h`` key is always written, the tiles'
    ``tiles_d2h`` only under ``profile``."""
    if profile:
        spans.fence(device)
        spans.put(prefix + "device", spans.since(since))
    with spans.span(prefix + "d2h", key=profile or not prefix):
        got = fetch(tensors)
    if profile:
        spans.put(prefix + "d2h_bytes",
                  int(sum(a.nbytes for a in got[:nmesh])))
    return got


def cast(node, dtype, device):
    """Copy of an SDF expression with every numeric leaf a ``dtype`` tensor
    on ``device`` (host leaves uploaded together, see ``upload``)."""
    host = [x for x in tree_leaves(node) if not isinstance(x, torch.Tensor)]
    it = iter(upload(host, dtype, device))

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(dtype=dtype, device=device)
        return next(it)

    return tree_map(leaf, node)


def load_leaves(node, leaves):
    """Copy of ``node`` carrying ``leaves``: numpy arrays in the flatten
    order of the ``sdf_tpu`` expression built by the same constructor calls,
    i.e. ``jax.tree_util.tree_leaves(cast(f, dtype))``.  As with a JAX
    unflatten, a subtree shared by several parents becomes one copy per
    occurrence, each with its own leaves.  Raises on a count or shape
    mismatch."""
    leaves = list(leaves)
    count = len(tree_leaves(node))
    if len(leaves) != count:
        raise ValueError("expected %d leaves, got %d" % (count, len(leaves)))
    it = iter(leaves)

    def put(old):
        new = np.asarray(next(it), dtype=np.float64)
        if new.shape != np.shape(old):
            raise ValueError(
                "leaf shape %s does not match %s" % (new.shape, np.shape(old))
            )
        return new

    return tree_map(put, node)


# --- nodes -----------------------------------------------------------------


class _Node:
    """Shared machinery for SDF2/SDF3 nodes."""

    _registry: dict = {}

    def __init__(self, fn, params):
        self.fn = fn
        self.params = params
        self._k = None

    def __call__(self, p, device=None):
        if isinstance(p, Points):
            return self.fn(self.params, p)
        # Public contract: (N, dim) -> (N, 1) in the points' dtype.  A tensor
        # stays on its device unless ``device`` is given; other points go to
        # ``device``, which is the card when None (see ``resolve_device``).
        if not isinstance(p, torch.Tensor) or device is not None:
            p = torch.as_tensor(p, device=resolve_device(device))
        node = cast(self, p.dtype, p.device)
        n = p.shape[0] if p.ndim == 2 else None
        if p.ndim == 2 and p.shape[0] == p.shape[1]:
            # N == dim is ambiguous with a (dim,) parameter vector inside
            # Points._coerce: pad one duplicate row (as the JAX package).
            p = torch.cat([p, p[:1]], dim=0)
        pts = Points.from_array(p)
        d = node.fn(node.params, pts)
        d = torch.as_tensor(d).broadcast_to(pts.bshape).reshape(-1, 1)
        return d if n is None or d.shape[0] == n else d[:n]

    def k(self, k=None):
        self._k = k
        return self

    def __getattr__(self, name):
        ops = type(self)._registry
        if name in ops:
            return functools.partial(ops[name], self)
        return self._getattr_fallthrough(name)

    def _getattr_fallthrough(self, name):
        raise AttributeError(name)

    def __or__(self, other):
        return type(self)._registry["union"](self, other)

    def __and__(self, other):
        return type(self)._registry["intersection"](self, other)

    def __sub__(self, other):
        return type(self)._registry["difference"](self, other)


class SDF3(_Node):
    """A 3D signed distance field: points ``(N, 3)`` -> distances ``(N, 1)``."""

    _registry = {}

    def _getattr_fallthrough(self, name):
        # Attributes of the eval function: mesh SDFs hang their sampled grid
        # there (``fn.array``, ``fn.xyz``, ...).  ``fn`` itself is never
        # looked up here, so a node still being built cannot recurse.
        if name == "fn" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.fn, name)

    def generate(self, *args, **kwargs):
        from . import engine

        return engine.generate(self, *args, **kwargs)

    def generate_mesh(self, *args, **kwargs):
        from . import engine

        return engine.generate_mesh(self, *args, **kwargs)

    def save(self, path, *args, **kwargs):
        from . import engine

        return engine.save(path, self, *args, **kwargs)

    def show_slice(self, *args, **kwargs):
        from . import engine

        return engine.show_slice(self, *args, **kwargs)

    def gradient(self, p, dtype=None, device=None):
        """Spatial gradient of the field at ``(N, 3)`` points: one autograd
        pass over the sum of the distances (the field is pointwise, so each
        point's gradient is its own).  ``dtype`` defaults to float32; the
        points go to ``device`` as in ``__call__`` (a tensor keeps its
        own)."""
        from .engine import resolve_dtype

        dtype = resolve_dtype(dtype)
        if not isinstance(p, torch.Tensor) or device is not None:
            p = torch.as_tensor(p, device=resolve_device(device))
        q = p.detach().to(dtype).requires_grad_(True)
        with torch.enable_grad():
            d = cast(self, dtype, q.device)(q)
            (g,) = torch.autograd.grad(d.sum(), q)
        return g

    def normal(self, p, dtype=None, device=None):
        """Unit surface normal (the normalized gradient) at ``(N, 3)``
        points; a zero gradient stays zero."""
        g = self.gradient(p, dtype, device)
        n = torch.linalg.vector_norm(g, dim=1, keepdim=True)
        return g / torch.where(n == 0, 1.0, n)


class SDF2(_Node):
    """A 2D signed distance field: points ``(N, 2)`` -> distances ``(N, 1)``."""

    _registry = {}


def node_k(node):
    """Evaluation-time read of a node's smooth-k tag (None if untagged)."""
    return getattr(node, "_k", None) if isinstance(node, _Node) else None


# Exceptions that say "this closure does not work in this calling
# convention", as opposed to a bug in the closure (NameError etc.), which
# propagates with its own traceback.  PyTorch reports shape and device
# mismatches as RuntimeError.
_TIER_ERRORS = (TypeError, ValueError, AttributeError, IndexError,
                RuntimeError)


def _wrap_legacy(f, dim):
    """Adapt a reference-style closure ``f(points_array) -> distances``
    (the counterpart of ``sdf_tpu.core.node._wrap_legacy``).

    Three tiers, chosen at the first evaluation and memoized:

      0. call ``f`` with the ``Points`` themselves (closures that stick to
         the arithmetic and indexing ``Points`` supports);
      1. call it with an ``(N, dim)`` tensor of the points, on their device;
      2. a plain host call: the points as float64 numpy, the closure run
         there (a verbatim numpy closure), and its result uploaded to the
         points' device -- the counterpart of ``jax.pure_callback``.

    Before tier 2 is taken the closure runs once on ``np.zeros((2, dim))``,
    so a real bug in it surfaces at once with its own traceback.  The
    closure captures its parameters where ``cast`` cannot reach them, so
    its output is cast to the points' dtype.  It is marked as a gather
    (``core.hybrid``): its field is always recorded ahead with torch ops
    and never enters a generated kernel body.
    """
    from .hybrid import mark_gather

    state = {"tier": None}

    def host(arr, shape):
        a = arr.detach().cpu().numpy().astype(np.float64)
        d = np.asarray(f(a), dtype=np.float64).reshape(-1)
        return torch.from_numpy(d).to(device=arr.device,
                                      dtype=arr.dtype).reshape(shape)

    def fn(q, p):
        if not isinstance(p, Points):
            return f(p)
        comps = [c for c in p.c if isinstance(c, torch.Tensor)]
        out_dtype = functools.reduce(torch.promote_types,
                                     [c.dtype for c in comps])
        device = comps[0].device

        def finish(d):
            # A numpy result means the closure left torch (possible on CPU
            # tensors only): take the host tier, as on the card.
            if not isinstance(d, (torch.Tensor, int, float)):
                raise TypeError("the closure did not return a tensor")
            return torch.as_tensor(d, device=device).to(out_dtype)

        if state["tier"] in (None, 0):
            try:
                out = finish(f(p))
                state["tier"] = 0
                return out
            except _TIER_ERRORS:
                # A tier-0 closure can fail in a new shape context: retry
                # the materialized tier rather than trusting the memo.
                state["tier"] = None
        shape = p.bshape
        arr = torch.stack(
            [torch.as_tensor(c).broadcast_to(shape).reshape(-1) for c in p.c],
            dim=-1)
        if state["tier"] in (None, 1):
            try:
                out = finish(f(arr)).reshape(shape)
                state["tier"] = 1
                return out
            except _TIER_ERRORS:
                pass
            f(np.zeros((2, dim)))
            state["tier"] = 2
        return host(arr, shape).to(out_dtype)

    fn.legacy_closure = True
    return mark_gather(fn)


def _make_ctor(cls, builder):
    @functools.wraps(builder)
    def wrapper(*args, **kwargs):
        out = builder(*args, **kwargs)
        if isinstance(out, _Node):
            return out
        if callable(out):
            # A reference-style constructor returning a bare closure: no
            # parameter leaves, the closure captures its values.
            return cls(_wrap_legacy(out, 2 if cls is SDF2 else 3), {})
        fn, params = out
        return cls(fn, params)

    return wrapper


def sdf3(builder):
    """Wrap a builder returning ``(fn, params)`` into an SDF3 constructor."""
    return _make_ctor(SDF3, builder)


def sdf2(builder):
    return _make_ctor(SDF2, builder)


def op3(builder):
    """Like ``sdf3`` but also registers the op as an SDF3 method."""
    wrapper = _make_ctor(SDF3, builder)
    SDF3._registry[builder.__name__] = wrapper
    return wrapper


def op2(builder):
    wrapper = _make_ctor(SDF2, builder)
    SDF2._registry[builder.__name__] = wrapper
    return wrapper


def op32(builder):
    """A 3D -> 2D operation: registered on SDF3, returns SDF2."""
    wrapper = _make_ctor(SDF2, builder)
    SDF3._registry[builder.__name__] = wrapper
    return wrapper


def op23(builder):
    """A 2D -> 3D operation: registered on SDF2, returns SDF3."""
    wrapper = _make_ctor(SDF3, builder)
    SDF2._registry[builder.__name__] = wrapper
    return wrapper
