"""Grid sampling + meshing engine (counterpart of ``sdf_tpu.core.engine``):
``generate()``, dense and tiled, on one device or sharded over the ranks of
a mesh (``parallel``).

  * bounds: the reference's 16^3 probe-grid refinement in the compute
    dtype with float64 loop state (machine-independent bounds, as in the
    JAX package), each round one launch of a probe kernel on the card
    (``eval_classify.bounds_probe``) where the expression records whole,
    else on the CPU; a card round with a value within ``BOUNDS_GUARD``
    ulps of the cutoff, or not finite, where it could move an extreme is
    evaluated again on the CPU, so the bounds are the CPU's wherever the
    card's values lie within that guard of the CPU's (read on an H100 for
    the zoo, the benchmark's configurations and every op, at most 1/64 of
    it; ``chip_smoke.py`` holds the zoo's bounds to the CPU's);
  * probe cull: the per-batch ``_skip`` test, evaluated with torch ops on
    the device and fetched together with the counts (speculation);
  * eval + classify: kernel B1 (``core.eval_classify``), after a torch
    pre-pass that records the fields of any gather-bearing subtree over
    the whole grid (``core.hybrid.record_dense_windows``), which B1 reads;
  * under ``mc_variant="lewiner"`` (the default) the 8-bit cases go through
    kernel B2 (``mc33.classify_ext``) and come back as extended codes;
  * count: ``mc.count_indexed`` (kernel B3), then ONE host sync for every
    count plus the cull mask;
  * emit: ``mc.emit_for_host`` (kernels B4, B3, B5) into buffers sized by
    ``mc.round_capacity``, then the readback ``mc.readback`` picks: a
    float32 volume on a card decoded there by kernel D1, which writes the
    mesh in its host layout, any other float32 emit packed;
  * decode: ``mc.readback``'s decode of the fetched arrays, views of the
    bytes after D1, else ``mc.unpack_indexed`` on the host.

``sparse="tiles"``, or ``sparse=True`` once the fetched cull mask shows that
at least ``AUTO_TILES_THRESHOLD`` of the batches are culled, runs the tiled
pipeline of ``core.sparse`` instead: only the kept tiles are evaluated
(kernel B6, or B7 for gather-bearing expressions), then B2, B3, B4 and B5
on the tile volumes.  A routed run discards its speculative dense result.
The route follows the cull alone, as in the JAX package: a gather-bearing
expression stays dense below the threshold, like any other.

Bounds and counts are deterministic in the expression, so both are
memoized on ``utils.checkpoint.fingerprint``: a repeat call on an
unchanged model probes nothing, dispatches emit without waiting for the
counts, and fetches the mesh and the pending statistics in one transfer.

Every entry point takes ``device=None``, meaning ``"cuda"``; without a card
that raises.  ``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np
import torch

from ..io import meshfmt, stl
from ..utils import checkpoint as ckpt
from ..utils import progress
from . import eval_classify, hybrid, mc, mc33, node, spans, sparse as sparse_mod
from .node import Points, cast, resolve_device, upload

WORKERS = None
SAMPLES = 2**22
BATCH_SIZE = 32

# Culled-batch fraction at which sparse=True routes to the tiled path: the
# dense pipeline evaluates everything and masks cells, a good trade only
# when little is culled.  Opt out with sparse=False, force with "tiles".
AUTO_TILES_THRESHOLD = 0.6

# Memos of deterministic results, keyed on checkpoint.fingerprint (structure,
# parameter leaves and closure statics): refined bounds per (expression,
# dtype), and the pre-emit counts (cells, triangles, edges, conflicted
# cells) per (expression, grid, dtype, cull mode, variant, device type).
# ``.k()`` tags and parameter edits change the fingerprint and miss.
_BOUNDS_MEMO = {}
_COUNTS_MEMO = {}
# The host cull mask of sparse="tiles" per (expression, grid, dtype, batch).
_SKIP_MEMO = {}
_EMPTY = np.empty(0)

# Structured report of the most recent generate(): span wall times in
# seconds (``core.spans``: each span's key sums its occurrences in the
# call; ``total`` is the root span's length), the counters of
# ``spans.COUNTERS``, and batch/triangle counts (the JAX package's keys).
LAST_STATS = {}

# When True, the dense generate() path fences device completion before
# its d2h phase and records ``stats["device"]`` (wall time from the
# first eval dispatch to the fence) and ``stats["d2h_bytes"]`` (the
# fetched mesh arrays) -- one extra host wait per run, off by default.
# Together with core.sparse.PROFILE for the tiles route it splits a warm
# e2e into device / transfer / host decode, so a slow transfer cannot
# masquerade as a device regression.  It also keeps the call's list of
# spans, ``stats["spans"]``: ``(name, start_ns, end_ns, parent)`` on the
# profiler's clock, a new list each call (``core.spans``); and, on a card,
# times the host's waits for it as ``wait`` spans (``stats["wait"]``): the
# fence, and the part of each ``node.fetch`` spent before the copy.
PROFILE = False

_MC_VARIANT_ALIASES = {"fast": "default"}


def resolve_dtype(dtype):
    """float32 (the default) or float64, given as a torch or numpy dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {np.dtype(np.float32): torch.float32,
               np.dtype(np.float64): torch.float64}.get(np.dtype(dtype))
    if out not in (torch.float32, torch.float64):
        raise ValueError("dtype must be float32 or float64, got %r" % (dtype,))
    return out


def _expand_tile_mask(keep, tile, shape):
    """Per-tile mask -> per-cell mask cut to ``shape`` (by broadcasting:
    ``repeat_interleave`` may sync with the host)."""
    tx, ty, tz = keep.shape
    m = keep[:, None, :, None, :, None].expand(tx, tile, ty, tile, tz, tile)
    m = m.reshape(tx * tile, ty * tile, tz * tile)
    return m[: shape[0], : shape[1], : shape[2]]


def _eval_points(sdf, points, dtype, device):
    """Evaluate an uncast expression on host (N, 3) float64 points ->
    (N,) tensor on ``device``."""
    sdf_c = cast(sdf, dtype, device)
    p = Points(*upload([points[:, i] for i in range(points.shape[1])], dtype,
                       device))
    return torch.as_tensor(sdf_c(p)).broadcast_to(p.bshape)


# The near-tie guard of the bounds rounds evaluated on the card
# (``_settled``, ``_widths``): a card value within delta = BOUNDS_GUARD * u
# * M of the round's cutoff c may lie on the other side of c on the CPU,
# where u is the dtype's unit roundoff and M the larger of c and the
# probe's largest absolute coordinate.  The card's values are bit-equal to
# PyTorch's CUDA kernels'; the CPU's transcendentals differ from those by a
# few ulps of their results, which the expression scales by about the
# point's coordinates.  BOUNDS_GUARD is the power of two at least 64 times
# the largest |v_card - v_cpu| / (u * M) read on an H100 over every round of
# the benchmark's configurations, the README example, the zoo's models and
# every primitive and op: 15.14 in float32 (``wrap_around``), 12.23 in
# float64, so 2^10 >= 969 (PERF.md).  M is the probe's own, not the round's
# largest: a round's eight central probes lie at the cutoff less the
# model's size (the reference's structural tie, which the 1e-4 slack of
# float32 settles), a margin of 1e-4 c, which the round's largest
# coordinate, 8.7 c, would have covered for any guard above 2^7; the
# probe's own M, c, leaves room up to 2^10.
BOUNDS_GUARD = 2.0**10
_UNIT_ROUNDOFF = {torch.float32: 2.0**-24, torch.float64: 2.0**-53}


def _cpu_probe(sdf, dtype):
    """The CPU's evaluator of the bounds rounds: a function from three host
    float64 axes to the values of their grid in ``dtype``, evaluated with
    torch ops on the CPU, as a float64 numpy volume.  The cast happens at
    the first call."""
    sdf_c = None

    def probe(X, Y, Z):
        nonlocal sdf_c
        if sdf_c is None:
            sdf_c = cast(sdf, dtype, "cpu")
        Xt, Yt, Zt = [torch.as_tensor(a, dtype=dtype) for a in (X, Y, Z)]
        p = Points(Xt[:, None, None], Yt[None, :, None], Zt[None, None, :])
        vol = torch.as_tensor(sdf_c(p)).broadcast_to(
            (len(X), len(Y), len(Z)))
        return vol.to(torch.float64).numpy()

    return probe


def _widths(X, Y, Z, c, dtype):
    """The near-tie width ``delta`` of each probe of a round's grid with the
    cutoff ``c`` (``BOUNDS_GUARD``): g u max(c, |x|, |y|, |z|), the outer
    maximum of each axis' g u max(c, |a|), exact since g u is a power of
    two."""
    gu = BOUNDS_GUARD * _UNIT_ROUNDOFF[dtype]
    dx, dy, dz = (gu * np.maximum(np.abs(a), c) for a in (X, Y, Z))
    return np.maximum(np.maximum(dx[:, None, None], dy[None, :, None]),
                      dz[None, None, :])


def _settled(vol, c, X, Y, Z, dtype):
    """The extremes of a round: the index rows ``[min, max]`` over the
    probes of its values ``vol`` (grid ``X x Y x Z``) with ``|v| <= c``,
    per axis, or no rows where there are none (all that the loop reads of
    ``argwhere``).  None where a value within its probe's ``delta``
    (``_widths``) of ``c`` could move them: the sure probes (``|v| <= c -
    delta``) are none while near ones (``c - delta < |v| <= c + delta``,
    and every value that is not finite, which the CPU may read finite)
    exist, or a near probe lies outside the sure ones' index range on some
    axis.  Otherwise any values within ``delta`` of the finite ones of
    ``vol`` give the same extremes."""
    a = np.abs(vol)
    odd = ~np.isfinite(a)
    # Every delta is at most the round's widest (the axes are monotone, so
    # their largest magnitudes are at their ends); twice it covers the
    # rounding of the comparisons, so no value that far from c is near.
    widest = BOUNDS_GUARD * _UNIT_ROUNDOFF[dtype] * max(
        c, *(abs(float(t[i])) for t in (X, Y, Z) for i in (0, -1)))
    if odd.any() or (np.abs(a - c) <= 2 * widest).any():
        delta = _widths(X, Y, Z, c, dtype)
        sure = a <= c - delta
        near = ~sure & ((a <= c + delta) | odd)
        if near.any():
            if not sure.any():
                return None
            for s, n in zip(_axis_hits(sure), _axis_hits(near)):
                if n[0] < s[0] or n[-1] > s[-1]:
                    return None
    hits = _axis_hits(a <= c)
    if not len(hits[0]):
        return np.empty((0, 3), np.int64)
    return np.array([[s[0] for s in hits], [s[-1] for s in hits]])


def _axis_hits(mask):
    """Per axis of a 3-D ``mask``, the indices where it holds somewhere."""
    return [np.flatnonzero(mask.any(axis=rest))
            for rest in ((1, 2), (0, 2), (0, 1))]


def _estimate_bounds_host(sdf, dtype, probe=None):
    """The reference's bounds refinement: up to 32 iterations of a 16^3
    probe grid, ALL loop arithmetic in host float64, the evaluations in
    ``dtype`` (see sdf_tpu.core.engine._estimate_bounds_host: the float64
    state keeps the trajectory machine-independent, and the 1e-4 slack at
    float32 moves the cutoff off structural ties).

    The rounds are evaluated on the CPU (``_cpu_probe``), or by ``probe``,
    the card's evaluator (``eval_classify.bounds_probe``).  Each of its
    rounds is settled by ``_settled``; a round it cannot settle is
    evaluated again on the CPU, whose values decide it, and counted in
    ``bounds_fallbacks``.  So wherever the card's finite values lie within
    ``delta`` of the CPU's, the bounds are the CPU's, bit for bit; a card
    value further off than that at an extreme could move a bound by a
    probe step."""
    s = 16
    slack = 0.0 if dtype == torch.float64 else 1e-4
    lo = np.full(3, -1e9)
    hi = np.full(3, 1e9)
    prev = None
    empty = True
    cpu = _cpu_probe(sdf, dtype)
    for _ in range(32):
        X = np.linspace(lo[0], hi[0], s)
        Y = np.linspace(lo[1], hi[1], s)
        Z = np.linspace(lo[2], hi[2], s)
        d = np.array([X[1] - X[0], Y[1] - Y[0], Z[1] - Z[0]])
        threshold = np.linalg.norm(d) / 2
        if threshold == prev:
            break
        prev = threshold
        spans.count("bounds_rounds")
        c = threshold * (1 + slack)
        where = None
        if probe is not None:
            where = _settled(probe(X, Y, Z), c, X, Y, Z, dtype)
            if where is None:
                spans.count("bounds_fallbacks")
        if where is None:
            spans.count("bounds_cpu_rounds")
            where = np.argwhere(np.abs(cpu(X, Y, Z)) <= c)
        if len(where) == 0:
            break
        empty = False
        hi = lo + where.max(axis=0) * d + d / 2
        lo = lo + where.min(axis=0) * d - d / 2
    return lo, hi, empty


def _fingerprint_or_none(sdf, X, Y, Z, extras):
    """The memo key, or None for an expression that cannot be hashed (an
    exotic closure): such a call just recomputes."""
    with spans.span("fingerprint"):
        try:
            return ckpt.fingerprint(sdf, X, Y, Z, extras)
        except Exception:
            return None


def _card_probe(sdf, dtype, device):
    """The card's evaluator of the bounds rounds on ``device``, or None
    where the rounds stay on the CPU: a CPU device, an expression with
    gather-marked subtrees, or one that records no body."""
    device = torch.device(device)
    if device.type != "cuda" or hybrid.count_gathers(sdf):
        return None
    try:
        return eval_classify.bounds_probe(sdf, dtype, device)
    except NotImplementedError:  # NoCppForm, or no body at all
        return None


def _estimate_bounds(sdf, dtype=torch.float32, device="cpu"):
    """Probe-grid bounds estimation (see ``_estimate_bounds_host``),
    memoized: the refinement is deterministic in the expression, so repeat
    ``generate()`` calls on an unchanged model reuse the result instead of
    evaluating up to 32 probe grids every time.  On a CUDA ``device`` the
    rounds of a gather-free expression with a body run on the card
    (``_card_probe``).  Their bounds are the CPU's wherever the card's
    values lie within ``BOUNDS_GUARD`` ulps of the CPU's (``_settled``),
    so the memo holds the same bounds whichever evaluated them; an op
    whose CUDA and CPU forms differ by more than that could make them
    differ."""
    fp = _fingerprint_or_none(sdf, _EMPTY, _EMPTY, _EMPTY, "bounds")
    key = None if fp is None else (fp, str(dtype))
    if key is not None and key in _BOUNDS_MEMO:
        return _BOUNDS_MEMO[key]
    lo, hi, empty = _estimate_bounds_host(sdf, dtype,
                                          _card_probe(sdf, dtype, device))
    if empty:
        raise ValueError(
            "bounds estimation failed (no surface found); pass bounds= explicitly"
        )
    out = (tuple(lo.tolist()), tuple(hi.tolist()))
    ckpt.memo_put(_BOUNDS_MEMO, key, out)
    return out


def _tile_slices(n, size):
    """Tile start indices and (lo, hi) sample index per tile."""
    starts = list(range(0, n, size))
    return [(i, min(i + size, n - 1)) for i in starts]


def _skip_probes(X, Y, Z, batch_size):
    """Probe points for the per-batch ``_skip`` test: center + 8 corners per
    tile.  Returns ``(probes (nt * 9, 3) float64, radii (nt,), (tx, ty,
    tz))``."""
    txs = _tile_slices(len(X), batch_size)
    tys = _tile_slices(len(Y), batch_size)
    tzs = _tile_slices(len(Z), batch_size)

    probes = []
    radii = []
    for lox, hix in txs:
        for loy, hiy in tys:
            for loz, hiz in tzs:
                x0, x1 = X[lox], X[hix]
                y0, y1 = Y[loy], Y[hiy]
                z0, z1 = Z[loz], Z[hiz]
                cx, cy, cz = (x0 + x1) / 2, (y0 + y1) / 2, (z0 + z1) / 2
                radii.append(np.linalg.norm([cx - x0, cy - y0, cz - z0]))
                probes.append(
                    [
                        (cx, cy, cz),
                        (x0, y0, z0),
                        (x0, y0, z1),
                        (x0, y1, z0),
                        (x0, y1, z1),
                        (x1, y0, z0),
                        (x1, y0, z1),
                        (x1, y1, z0),
                        (x1, y1, z1),
                    ]
                )
    probes = np.array(probes, dtype=np.float64).reshape(-1, 3)
    return probes, np.array(radii), (len(txs), len(tys), len(tzs))


def _skip_mask(sdf, X, Y, Z, batch_size, dtype):
    """Host form of the per-batch ``_skip`` test: values evaluated on the
    CPU in ``dtype``, compared in float64.  Returns a (tx, ty, tz) bool
    array, True = skip."""
    probes, radii, tshape = _skip_probes(X, Y, Z, batch_size)
    values = _eval_points(sdf, probes, dtype, "cpu").to(torch.float64)
    values = values.numpy().reshape(-1, 9)
    center = np.abs(values[:, 0])
    corners = values[:, 1:]
    far = center > radii * (1 + 1e-4)
    first_pos = corners[:, 0] > 0
    same = np.where(
        first_pos, np.all(corners > 0, axis=1), np.all(corners < 0, axis=1)
    )
    return (far & same).reshape(tshape)


def _skip_mask_device(sdf, X, Y, Z, batch_size, dtype, device):
    """The ``_skip`` test with torch ops on ``device``, comparisons in the
    evaluation dtype, WITHOUT a host sync: returns ``(mask (nt,) bool
    tensor, (tx, ty, tz))`` so the fetch rides the counts transfer."""
    probes, radii, tshape = _skip_probes(X, Y, Z, batch_size)
    values = _eval_points(sdf, probes, dtype, device).reshape(-1, 9)
    (thresh,) = upload([radii * (1 + 1e-4)], dtype, device)
    center = torch.abs(values[:, 0])
    corners = values[:, 1:]
    far = center > thresh
    first_pos = corners[:, 0] > 0
    same = torch.where(
        first_pos, torch.all(corners > 0, dim=1), torch.all(corners < 0, dim=1)
    )
    return far & same, tshape


# Box triangulation for debug markers: 36 corner ids (12 triangles) over
# corners ordered product((x0,x1),(y0,y1),(z0,z1)).
_DEBUG_BOX_IDX = np.array(
    [3, 5, 7, 5, 3, 1, 0, 6, 4, 6, 0, 2, 0, 5, 1, 5, 0, 4,
     5, 6, 7, 6, 5, 4, 6, 3, 7, 3, 6, 2, 0, 3, 2, 3, 0, 1]
)


def _debug_triangles(X, Y, Z, tiles, batch_size, inset=0.25):
    """Inset marker boxes for a list of (i, j, k) tile indices ->
    (36 * ntiles, 3) float64."""
    tiles = np.asarray(tiles).reshape(-1, 3)
    if len(tiles) == 0:
        return np.zeros((0, 3), dtype=np.float64)
    s = batch_size
    axes = []
    for coords, t in zip((X, Y, Z), tiles.T):
        lo = coords[t * s]
        hi = coords[np.minimum(t * s + s, len(coords) - 1)]
        span = (hi - lo) * inset
        axes.append((lo + span, hi - span))
    corner_id = np.arange(8)
    corners = np.stack(
        [
            np.where((corner_id >> (2 - a)) & 1, axes[a][1][:, None],
                     axes[a][0][:, None])
            for a in range(3)
        ],
        axis=-1,
    )
    return corners[:, _DEBUG_BOX_IDX, :].reshape(-1, 3).astype(np.float64)


def _variant_tag(mc_variant):
    """The variant's part of a memo or checkpoint key (none for the
    tables that were the only ones once)."""
    return (mc_variant,) if mc_variant != "default" else ()


def _dense_path(sdf, X, Y, Z, s, dtype, device, mc_variant, speculate, bar,
                num_batches):
    """The dense pipeline of ``generate()``: returns ``(indexed (verts,
    faces), per_tile, skip, conflicted or None)`` with host arrays.

    ``speculate`` (sparse=True): the cull test is dispatched but not
    fetched, the dense pipeline is dispatched behind it with the
    device-resident mask, and the mask comes back with the counts in one
    transfer.  If the fetched mask then shows at least AUTO_TILES_THRESHOLD
    of the batches culled, the dense result is discarded and ``indexed`` is
    None: the caller meshes the kept tiles instead (such a run is never
    put in the counts memo)."""
    sshape = (-(-len(X) // s), -(-len(Y) // s), -(-len(Z) // s))
    if speculate:
        with spans.span("skip_dispatch"):
            skip_dev, sshape = _skip_mask_device(sdf, X, Y, Z, s, dtype,
                                                 device)
        skip3d = skip_dev.reshape(sshape)
    else:
        skip3d = torch.zeros(sshape, dtype=torch.bool, device=device)

    dev0 = spans.clock()  # device-pipeline start (PROFILE)
    # Under sparse=True, the dense pass up to the routing decision is the
    # speculative span: a routed call discards it.
    with spans.span("speculative") if speculate else contextlib.nullcontext():
        fields = None
        if hybrid.count_gathers(sdf):
            # Kernel B1's pre-pass: the gather-bearing subtrees' fields over
            # the whole grid, on the device, before the kernel that reads
            # them.
            with spans.span("record_fields"):
                fields = eval_classify.record_fields(sdf, X, Y, Z, dtype,
                                                     device)
        with spans.span("eval_classify"):
            vol, case = eval_classify.eval_and_classify(sdf, X, Y, Z, dtype,
                                                        device, fields)
        del fields  # B1 was their one reader: free them before the emit
        if mc_variant != "default":
            # Extend kernel B1's 8-bit codes with the variant's
            # saddle/interior bits (reusing them instead of re-deriving
            # corner signs).
            with spans.span("classify_ext"):
                case = mc33.classify_ext(vol, base_case=case)
        bar.update(num_batches * 0.6)

        cshape = (len(X) - 1, len(Y) - 1, len(Z) - 1)
        keep = _expand_tile_mask(~skip3d, s, cshape)
        tshape = tuple(-(-c // s) for c in cshape)
        with spans.span("mc_count"):
            ncells_dev, total, n_edges, per_tile_dev, active, emask = (
                mc.count_indexed(vol, case, keep, s, tshape, mc_variant)
            )
        confl = None
        pending = [per_tile_dev, skip3d]  # statistics not fetched yet
        counts = [ncells_dev, total, n_edges]
        if mc_variant == "lewiner":
            # Observability for majority-voted table entries; rides the
            # counts transfer below.
            counts.append(mc33.count_conflicted(case, keep))

        # Counts are deterministic in (expression, grid, dtype, cull mode,
        # variant, and the device type: sin and cos differ between the CPU
        # and the card): a repeat generate() of an unchanged model reuses
        # them, dispatches emit at once and lets the statistics ride the
        # mesh transfer.  A non-speculative run reaches here only with the
        # all-False mask of sparse=False, so the flag stands for the mask.
        ckey = _fingerprint_or_none(
            sdf, X, Y, Z,
            ("counts", str(dtype), s, bool(speculate), device.type)
            + _variant_tag(mc_variant),
        )
        with spans.span("counts"):
            memo = _COUNTS_MEMO.get(ckey) if ckey is not None else None
            if memo is not None:
                n_cells, n, ne, confl = memo
                if n_cells == 0:
                    per_tile, skip = node.fetch(pending)
                    pending = []
            else:
                # The one host sync before emit: every count, the per-tile
                # counters and the cull mask in a single transfer.
                got = node.fetch(counts + pending)
                pending = []
                n_cells, n, ne = (int(v) for v in got[:3])
                if mc_variant == "lewiner":
                    confl = int(got[3])
                per_tile, skip = got[-2], got[-1]
        bar.update(num_batches * 0.8)

        routed = (memo is None and speculate
                  and skip.mean() >= AUTO_TILES_THRESHOLD)
    if memo is None and not routed:  # a routed run is never memoized
        ckpt.memo_put(_COUNTS_MEMO, ckey, (n_cells, n, ne, confl))

    if routed:
        # The cull removed most of the volume: discard the dense result
        # (device time only).
        indexed = None
    elif n_cells == 0:
        indexed = (
            np.zeros((0, 3), dtype=np.float64),
            np.zeros((0, 3), dtype=np.int32),
        )
    else:
        cell_capacity = mc.round_capacity(n_cells)
        capacity = mc.round_capacity(n)
        edge_capacity = mc.round_capacity(ne)
        with spans.span("mc_emit"):
            mesh, decode = mc.emit_for_host(
                vol, case, active, emask, edge_capacity, capacity,
                cell_capacity, ne, n, variant=mc_variant,
            )
        # One transfer: the mesh and, on a memoized run, the statistics.
        got = node.fetch_mesh(mesh + pending, len(mesh), device, dev0,
                              profile=PROFILE)
        if pending:
            per_tile, skip = got[len(mesh):]
        with spans.span("decode"):
            indexed = decode(got[:len(mesh)])
    return indexed, per_tile, skip, confl


def generate(
    sdf,
    step=None,
    bounds=None,
    samples=SAMPLES,
    workers=WORKERS,
    batch_size=BATCH_SIZE,
    verbose=True,
    sparse=True,
    dtype=None,
    mesh=None,
    checkpoint=None,
    debug=False,
    output="points",
    mc_variant="lewiner",
    device=None,
):
    """Sample the SDF on a dense grid and mesh it (see
    sdf_tpu.core.engine.generate for the contract).

    Returns a flat (3*T, 3) float64 array of world-space vertices, three
    rows per triangle; ``output="mesh"`` returns ``(verts (V, 3) float64,
    faces (T, 3) int32)``.  ``device=None`` runs on the card (``"cuda"``)
    and raises without one; ``device="cpu"`` runs the plain versions.

    ``mc_variant=`` selects the marching-cubes topology rule: "lewiner"
    (the default) resolves every ambiguity from the cell's trilinear
    interpolant (face-saddle + interior tests, kernel B2), "fast" uses the
    fixed separated-ambiguity tables and skips that classification
    ("default" is a legacy alias of "fast").  ``checkpoint=`` names a file
    that persists the soup keyed on a fingerprint of the run configuration;
    a matching re-run resumes from it (see ``utils.checkpoint``).

    ``sparse=`` selects the cull: True (the default) evaluates the dense
    grid behind a speculative probe cull and, when the cull removed at least
    ``AUTO_TILES_THRESHOLD`` of the batches, discards that and evaluates
    only the kept tiles; ``"tiles"`` goes to the tiles at once; False meshes
    every batch densely.  An expression with gather-marked subtrees
    (``core.hybrid``) takes the same routes: kernel B1 on the dense grid
    and kernel B7 on the tiles read the subtrees' fields, recorded ahead
    with torch ops.  So does every subtree whose own function calls an op
    the kernels' body has no form for (``hybrid.route_fields``; such a run
    names the ops in ``LAST_STATS["field_route_ops"]`` and counts the
    subtrees in ``["field_route_nodes"]``).

    ``mesh=`` (a 1-D ``DeviceMesh`` of ``torch.distributed``, see
    ``parallel.make_mesh``) shards the run over its ranks, one process and
    one device a rank: ``sparse="tiles"`` (or ``sparse=True`` once the host
    cull removes ``AUTO_TILES_THRESHOLD`` of the batches) deals the tile
    list over them (``parallel.sparse``), every other setting cuts the grid
    into z slabs (``parallel.grid``).  Each rank returns its own share of
    the mesh and the global statistics; ``parallel.gather_triangles``
    assembles the shares.  With ``torch.distributed`` running more than one
    rank, ``mesh=None`` shards over all of them; a mesh of one rank is the
    single-device run.  No speculative cull under a mesh, and
    ``mc33_conflicted_cells`` is absent from ``LAST_STATS`` there.

    ``LAST_STATS`` reports the call (an empty grid or a resumed checkpoint
    leaves the last one's).  Every host millisecond of it lies under the
    root span ``generate``, whose length is ``total``; the spans below it
    (``core.spans``) add their seconds to keys of their names:
    ``route_fields``, ``bounds``, ``fingerprint`` (every memo key and the
    tiles' cull-mask hash), ``skip_dispatch`` or ``skip_mask`` (the cull),
    ``speculative`` (under ``sparse=True``, the dense pass up to the
    routing decision, which a routed call discards: ``record_fields``,
    ``eval_classify``, ``classify_ext``, ``mc_count``, ``counts``),
    ``counts`` (the pre-emit counts fetch), ``kernel_source`` (the eval
    kernels' source and library lookup: B6/B7 at each launch, B1 and the
    bounds probe once a tree), ``mc_emit``,
    ``d2h``, ``decode`` (the host's decode, or its views of D1's bytes),
    ``sparse_tiles`` (the tiles route), and
    ``transform`` (the world transform and the per-tile statistics).  The
    counters: ``host_waits`` (``node.fetch`` calls: 2 for a dense call that
    misses the counts memo, 1 on a hit, 3 for a routed call, and one more
    for each bounds round evaluated on the card), ``bounds_rounds`` (probe
    grids of the bounds refinement, 0 on a memo hit: many rounds tell a
    slow refinement from a slow expression), ``bounds_fallbacks`` (card
    rounds settled on the CPU), ``bounds_cpu_rounds`` (rounds whose values
    the CPU evaluated: all of them on a CPU device or for an expression
    with gather-marked subtrees, the fallbacks otherwise),
    ``kernel_sources`` (sources generated for kernels B1/B6/B7 and the
    bounds probe), ``recorded_fields`` (the fields of gather-bearing
    subtrees recorded by B1's pre-pass, ``record_fields``) and
    ``card_decodes`` (meshes decoded on the card by kernel D1,
    ``mc.decode_on_card``: 1 for a float32 call on a card that meshes
    anything, 0 on the CPU or in float64).  A texture
    built before the call (``image``, ``text``) adds the seconds of its
    host build to ``texture`` (``core.spans``, a held span).  The bounds
    are those of the refinement on the CPU wherever the card's values of
    its rounds lie within ``BOUNDS_GUARD`` ulps of the CPU's
    (``_estimate_bounds``), so every rank of a ``mesh=`` call gets the
    same ones.  Under
    ``PROFILE``: ``spans``, ``wait``, ``device``, ``d2h_bytes`` and, with
    ``sparse.PROFILE``, ``tiles_device``, ``tiles_d2h``,
    ``tiles_d2h_bytes``, ``tiles_decode`` (see ``PROFILE``).
    """
    stats = {}
    with spans.call(stats, PROFILE) as root:
        out = _generate(sdf, step, bounds, samples, workers, batch_size,
                        verbose, sparse, dtype, mesh, checkpoint, debug,
                        output, mc_variant, device, stats)
    if "triangles" not in stats:  # an empty grid or a resumed checkpoint
        return out
    stats["total"] = root.seconds
    LAST_STATS.clear()
    LAST_STATS.update(stats)
    if verbose:
        print("%d skipped, %d empty, %d nonempty"
              % (stats["skipped"], stats["empty"], stats["nonempty"]))
        if stats.get("mc33_conflicted_cells"):
            print(
                "%d cells hit majority-voted MC33 table entries "
                "(docs/TOPOLOGY.md section 4.2)"
                % stats["mc33_conflicted_cells"]
            )
        print("%d triangles in %g seconds" % (stats["triangles"],
                                              root.seconds))
    return out


def _generate(sdf, step, bounds, samples, workers, batch_size, verbose,
              sparse, dtype, mesh, checkpoint, debug, output, mc_variant,
              device, stats):
    """The body of ``generate()``, inside its root span: the result, with
    the call's statistics in ``stats``."""
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    mc_variant = _MC_VARIANT_ALIASES.get(mc_variant, mc_variant)
    mc.get_tables(mc_variant)  # validate the name / load tables eagerly
    if output not in ("points", "mesh"):
        raise ValueError("output must be 'points' or 'mesh', got %r" % output)
    if output == "mesh" and checkpoint is not None:
        raise ValueError("output='mesh' does not support checkpoint=")
    if not isinstance(sparse, str) and sparse in (True, False):
        sparse = bool(sparse)
    elif sparse != "tiles":
        raise ValueError("sparse must be True, False or 'tiles'")
    mesh = _resolve_mesh(mesh, device)
    # Subtrees whose ops have no form in the eval kernels' body become
    # recorded fields (the reference's fallback from its kernel to XLA).
    with spans.span("route_fields"):
        sdf, routed_ops = hybrid.route_fields(sdf, stats, dtype)
    if routed_ops and verbose:
        print("%d subtree(s) evaluated ahead as fields, for want of a "
              "kernel form of: %s" % (len(routed_ops),
                                      ", ".join(sorted(set(routed_ops)))))
    if mesh is not None and checkpoint is not None:
        raise ValueError("checkpoint= is not supported with a mesh: each "
                         "rank holds only its share of the mesh")
    ndev = 1 if mesh is None else mesh.size()
    want_indexed = output == "mesh" and not debug

    if workers is not None:
        warnings.warn(
            "generate(workers=...) has no effect: the work runs on one "
            "device, not a thread pool",
            stacklevel=2,
        )

    if bounds is None:
        with spans.span("bounds"):
            bounds = _estimate_bounds(sdf, dtype, device)
    (x0, y0, z0), (x1, y1, z1) = bounds

    if step is None and samples is not None:
        volume = (x1 - x0) * (y1 - y0) * (z1 - z0)
        step = (volume / samples) ** (1 / 3)

    try:
        dx, dy, dz = step
    except TypeError:
        dx = dy = dz = step

    if verbose:
        print("min %g, %g, %g" % (x0, y0, z0))
        print("max %g, %g, %g" % (x1, y1, z1))
        print("step %g, %g, %g" % (dx, dy, dz))

    X = np.arange(x0, x1, dx)
    Y = np.arange(y0, y1, dy)
    Z = np.arange(z0, z1, dz)

    s = batch_size
    num_batches = (-(-len(X) // s)) * (-(-len(Y) // s)) * (-(-len(Z) // s))
    lens = lambda n: [min(n - i, s + 1) for i in range(0, n, s)]
    num_samples = sum(
        lx * ly * lz
        for lx in lens(len(X)) for ly in lens(len(Y)) for lz in lens(len(Z))
    )

    if verbose:
        print(
            "%d samples in %d batches with %d devices"
            % (num_samples, num_batches, ndev)
        )

    bar = progress.Bar(num_batches, enabled=verbose)

    if len(X) < 2 or len(Y) < 2 or len(Z) < 2:
        bar.done()
        if output == "mesh":
            return (
                np.zeros((0, 3), dtype=np.float64),
                np.zeros((0, 3), dtype=np.int32),
            )
        return np.zeros((0, 3), dtype=np.float64)

    variant_tag = _variant_tag(mc_variant)
    fp = None
    if checkpoint is not None:
        # batch_size changes the cull granularity (a different triangle set
        # for inexact SDFs) and debug= changes the returned points: both
        # must invalidate a cached mesh.
        with spans.span("fingerprint"):
            fp = ckpt.fingerprint(
                sdf, X, Y, Z,
                (sparse, str(dtype), s, bool(debug)) + variant_tag
            )
        cached = ckpt.load(checkpoint, fp)
        if cached is not None:
            bar.done()
            if verbose:
                print("resumed %d triangles from %s"
                      % (len(cached) // 3, checkpoint))
            return cached

    def tiles_path(skip):
        # Tiled sparse pipeline: evaluate only the tiles the probe cull
        # kept; work scales with surface area instead of grid volume.
        mkey = _fingerprint_or_none(
            sdf, X, Y, Z,
            ("tiles-counts", str(dtype), s, device.type) + variant_tag,
        )
        with spans.span("sparse_tiles"):
            return sparse_mod.mesh_sparse_tiles(
                sdf, X, Y, Z, skip, s, dtype, device, memo_key=mkey,
                variant=mc_variant, stats=stats,
            )

    def host_skip():
        # The cull mask evaluated on the host (memoized per expression and
        # grid): the tile list is made from it, and every rank of a mesh
        # computes the same one.
        with spans.span("skip_mask"):
            skey = _fingerprint_or_none(sdf, X, Y, Z, ("skip", str(dtype), s))
            skip = _SKIP_MEMO.get(skey) if skey is not None else None
            if skip is None:
                skip = _skip_mask(sdf, X, Y, Z, s, dtype)
                ckpt.memo_put(_SKIP_MEMO, skey, skip)
        bar.update(num_batches * 0.1)
        return skip

    # mc33_conflicted_cells is counted by the dense pipeline only: a run
    # that goes to the tiles at once, or runs on a mesh, leaves the key out
    # of LAST_STATS.
    confl = None
    if mesh is not None:
        from ..parallel import grid as pgrid, sparse as psparse

        if sparse:
            skip = host_skip()
        else:
            skip = np.zeros((-(-len(X) // s), -(-len(Y) // s),
                             -(-len(Z) // s)), dtype=bool)
        if sparse is True and skip.mean() >= AUTO_TILES_THRESHOLD:
            sparse = "tiles"
            stats["auto_tiles"] = round(float(skip.mean()), 4)
        if sparse == "tiles":
            # The active-tile list dealt over the ranks.
            with spans.span("sparse_tiles_sharded"):
                indexed, per_tile = psparse.mesh_sparse_tiles_sharded(
                    sdf, X, Y, Z, skip, s, mesh, dtype, device,
                    return_indexed=True, variant=mc_variant)
        else:
            with spans.span("mesh_and_march"):
                indexed, per_tile = pgrid.mesh_and_march(
                    sdf, X, Y, Z, skip, s, mesh, dtype, device,
                    return_indexed=True, variant=mc_variant)
        bar.update(num_batches * 0.8)
    elif sparse == "tiles":
        skip = host_skip()
        indexed, per_tile = tiles_path(skip)
        bar.update(num_batches * 0.8)
    else:
        indexed, per_tile, skip, confl = _dense_path(
            sdf, X, Y, Z, s, dtype, device, mc_variant, sparse is True, bar,
            num_batches,
        )
        if indexed is None:  # the cull routed the run to the tiles
            stats["auto_tiles"] = round(float(skip.mean()), 4)
            indexed, per_tile = tiles_path(skip)

    with spans.span("transform"):
        scale = np.array([dx, dy, dz])
        offset = np.array([X[0], Y[0], Z[0]])
        mverts = indexed[0] * scale + offset
        mfaces = indexed[1]
        points = None if want_indexed else mverts[mfaces.reshape(-1)]
        # per_tile is sized on cell tiles, which can be one short of the
        # sample-tile grid when an axis has a degenerate 1-sample last tile.
        pt = np.zeros(skip.shape, dtype=np.int64)
        a, b, c = per_tile.shape
        pt[:a, :b, :c] = per_tile[: skip.shape[0], : skip.shape[1],
                                  : skip.shape[2]]
        skipped = int(skip.sum())
        nonempty = int(((pt > 0) & ~skip).sum())
        empty = num_batches - skipped - nonempty
    bar.done()

    if checkpoint is not None:
        ckpt.save(checkpoint, fp, points)

    if debug and (mesh is None or mesh.get_local_rank() == 0):
        # Under a mesh the statistics are global: one rank adds the boxes.
        flagged = np.argwhere(skip | (pt == 0))
        points = np.concatenate(
            [points, _debug_triangles(X, Y, Z, flagged, s)], axis=0
        )
    triangles = len(mfaces) if points is None else len(points) // 3
    if confl is not None:
        stats["mc33_conflicted_cells"] = confl
    stats.update(
        batches=num_batches,
        samples=num_samples,
        skipped=skipped,
        empty=empty,
        nonempty=nonempty,
        triangles=triangles,
    )

    if output == "mesh":
        if points is not None:  # debug boxes are soup-only: dedup on host
            return meshfmt.dedup(points)
        return mverts, mfaces
    return points


def generate_mesh(sdf, *args, **kwargs):
    """``generate`` returning an indexed mesh: ``(verts (V, 3) float64
    world-space, faces (T, 3) int32)``."""
    return generate(sdf, *args, output="mesh", **kwargs)


def _resolve_mesh(mesh, device):
    """The mesh a run shards over: ``mesh``, or every rank of a
    ``torch.distributed`` world of more than one when None; None (one
    device) for no mesh or a mesh of one rank."""
    if mesh is None:
        from ..parallel import grid as pgrid

        mesh = pgrid.world_mesh(device)
    if mesh is not None and mesh.size() == 1:
        return None
    return mesh


def save(path, sdf, *args, mesh=None, **kwargs):
    """Generate and write the mesh: a binary STL, or by extension the
    indexed formats of ``io.meshfmt`` (OBJ, PLY).  Under a mesh (``mesh=``,
    or every rank of a ``torch.distributed`` world of more than one), the
    ranks' shares are gathered, rank 0 writes the whole mesh and every
    rank returns it."""
    mesh = _resolve_mesh(mesh, kwargs.get("device"))
    points = generate(sdf, *args, mesh=mesh, **kwargs)
    if mesh is not None:
        from .. import parallel

        points = parallel.gather_triangles(points, mesh)
        parallel.write_on_process0(path, points, mesh)
        return points
    if path.lower().endswith(".stl"):
        stl.write_binary_stl(path, points)
    else:
        meshfmt.write_mesh(path, points)
    return points


def sample_slice(sdf, w=1024, h=1024, x=None, y=None, z=None, bounds=None,
                 dtype=None, device=None):
    """Sample one axis-aligned plane of the field for debugging (see
    sdf_tpu.core.engine.sample_slice).

    Exactly one of x/y/z fixes the plane; the two free axes carry ``w`` and
    ``h`` samples (ascending axis order).  Returns ``(a, extent, axes)``:
    ``a[i, j]`` (float64 numpy) the distance at (first_free[i],
    second_free[j]), ``extent``/``axes`` ready for ``imshow``.  One torch
    evaluation over the ``(w, 1) x (1, h)`` plane on ``device`` (the card
    when None), no point array materialized."""
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    if bounds is None:
        bounds = _estimate_bounds(sdf, dtype, device)
    lo, hi = bounds

    fixed = {0: x, 1: y, 2: z}
    chosen = [a for a, v in fixed.items() if v is not None]
    if len(chosen) != 1:
        raise Exception("x, y, or z position must be specified")
    axis = chosen[0]
    free = [a for a in range(3) if a != axis]

    spans = {a: np.linspace(lo[a], hi[a], n) for a, n in zip(free, (w, h))}
    coords = [None] * 3
    coords[axis], coords[free[0]], coords[free[1]] = upload(
        [np.asarray(fixed[axis], np.float64).reshape(1, 1),
         spans[free[0]][:, None], spans[free[1]][None, :]], dtype, device)
    with torch.no_grad():
        d = cast(sdf, dtype, device)(Points(*coords))
        a = torch.as_tensor(d).broadcast_to((w, h))
        a = node.fetch([a])[0].astype(np.float64)
    s1, s2 = spans[free[0]], spans[free[1]]
    extent = (s2[0], s2[-1], s1[0], s1[-1])
    axes = "XYZ"[free[1]] + "XYZ"[free[0]]
    return a, extent, axes


def show_slice(*args, **kwargs):
    """Plot a slice with matplotlib (imported on the call); ``abs=True``
    shows |d|."""
    import matplotlib.pyplot as plt

    show_abs = kwargs.pop("abs", False)
    a, extent, axes = sample_slice(*args, **kwargs)
    im = plt.imshow(np.abs(a) if show_abs else a, extent=extent,
                    origin="lower")
    plt.xlabel(axes[0])
    plt.ylabel(axes[1])
    plt.colorbar(im)
    plt.show()
