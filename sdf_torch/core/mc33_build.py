"""The lewiner (trilinear-faithful) table set and its derivation
(counterpart of ``sdf_tpu.core.mc33_build``): the layout of the extended
case code, the guarded interior test, and the builder of
``mc33_tables.npz``.

``ext = OFFSET[case] + facebits * 9 + ibits`` where ``case`` is the 8-bit
corner-sign code, ``facebits`` packs one *joined* bit per ambiguous face of
the case (set iff the bilinear saddle on that face is inside: Lewiner's face
test) and ``ibits = s1 + 3 * s2`` in [0, 9) describes the trilinear's two
body saddles (``s1`` the index-1 saddle, ``s2`` the index-2 one: 0 = absent
or outside the open cell, 1 = inside with a negative critical value, 2 =
inside with a positive one).  ``sum_case 2^n_ambiguous(case) * 9 = 5904``
codes in all: OFFSET reaches 5,895 and a WEIGHT at most 288 (= 9 * 2^5).

The derivation (``build_tables``, run by
``tools/build_mc33_tables_torch.py``): for every case, sample realizations
(corner values with the case's signs), bucket them by ``facebits * 9 +
ibits``, and derive each bucket's surface topology from a dense oracle: the
trilinear sampled on an ``n^3`` grid, its inside (``f < 0``) and outside
(``f >= 0``) sets labelled with 6-connectivity, and the boundary loops of
``loops_of`` grouped by the (inside, outside) component pair they separate
(``loop_partition``).  A loop that touches two components means the grid
was too coarse: ``n`` doubles up to 512.  Each group is triangulated
(``triangulate_component``).

What runs where: the random draws are numpy's on the host, from one
``np.random.default_rng(seed)`` in the reference's order -- only that
stream reproduces the shipped tables -- and are moved to the device after
they are drawn.  The bucket keys (``face_joined_bits``, ``interior_bits``)
are torch on the device in float64; the labelling is kernel L1
(``csrc/label3d.cu``, wrapper ``label_corners``) on a CUDA tensor and its
plain version on a CPU tensor; loops, partitions, votes and triangulation
are host Python.  ``build_tables(device="cuda")`` equals the committed
``mc33_tables.npz`` array for array; ``mc33.load_tables`` checks the file
against ``build_offsets`` below.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..ops import vecmath as vm
from .mc_tables import CORNER_OFFSETS, EDGE_CORNERS, _EDGE_INDEX, _FACES
from .node import resolve_device


def face_is_ambiguous(case, face):
    """True iff the face's four corners alternate in sign for this case."""
    bits = [(case >> c) & 1 for c in _FACES[face]]
    return bits[0] == bits[2] and bits[1] == bits[3] and bits[0] != bits[1]


def ambiguous_faces(case):
    return [f for f in range(6) if face_is_ambiguous(case, f)]


def build_offsets():
    """OFFSET[case] (ext base index) and WEIGHT[case, face] (contribution of
    face ``f``'s joined bit to ``facebits * 9``: ``9 * 2^rank`` among the
    case's ambiguous faces, 0 for unambiguous faces), and the code count."""
    offset = np.zeros(256, dtype=np.int32)
    weight = np.zeros((256, 6), dtype=np.int32)
    nxt = 0
    for case in range(256):
        offset[case] = nxt
        amb = ambiguous_faces(case)
        for rank, f in enumerate(amb):
            weight[case, f] = (1 << rank) * 9
        nxt += (1 << len(amb)) * 9
    return offset, weight, nxt


OFFSET, WEIGHT, N_EXT = build_offsets()

# Guard width for every floating-point decision in the interior test, in
# ulps of the decided quantity's term-magnitude scale (see interior_flags).
GUARD_ULPS = 64.0


def interior_flags(c, eps):
    """``(neg1, pos1, neg2, pos2)`` interior-saddle flags of the trilinear
    interpolant of the 8 per-cell corner tensors ``c`` (CORNER_OFFSETS
    order, one common shape); ``eps`` is the machine epsilon of their dtype.

    ``neg1``/``pos1``: an index-1 body saddle (det H < 0) lies strictly
    inside the open cell with a negative / positive critical value;
    ``neg2``/``pos2`` likewise for the index-2 saddle.  Critical points
    solve grad f = 0: ``A z^2 + B z + C = 0`` with the stable quadratic
    formula (roots q/A and C/q), then x and y from z.  Every decision
    carries a forward error bound of GUARD_ULPS ulps so that degenerate
    cells (flat faces, boundary double roots, exact-tie critical values)
    decide identically wherever the same single IEEE operations run in the
    same order -- see sdf_tpu.core.mc33_build.interior_flags for the
    derivation.

    THE ORDER OF EVALUATION IS THE CONTRACT: this is that function term
    for term, every parenthesis kept, and ``csrc/classify_ext.cu`` repeats
    it once more.  Only + - * / sqrt abs, comparisons and selects occur;
    ``2.0 * x``, ``4.0 * x`` and ``-0.5 * x`` are exact, and nothing is
    divided by a Python number.  The square root is ``vecmath.sqrt``
    (correctly rounded on the CPU too); ``torch.clamp(min=0.0)`` passes a
    NaN on like ``jnp.maximum``.  Temporaries die as soon as Python drops
    their names, so a whole 2^24 float64 grid fits the card.
    """
    c000, c100, c110, c010, c001, c101, c111, c011 = c
    k1 = c100 - c000
    k2 = c010 - c000
    k3 = c001 - c000
    k4 = c110 - c000 - k1 - k2
    k5 = c101 - c000 - k1 - k3
    k6 = c011 - c000 - k2 - k3
    k7 = c111 - c000 - k1 - k2 - k3 - k4 - k5 - k6
    g = GUARD_ULPS * eps
    ab = torch.abs

    m = k3 * k7 - k5 * k6
    sm = ab(k3 * k7) + ab(k5 * k6)
    A = k7 * m
    B = 2.0 * (k4 * m)
    C = k3 * (k4 * k4) - k4 * (k2 * k5 + k1 * k6) + k7 * (k1 * k2)
    errA = g * (ab(k7) * sm)
    errB = 2.0 * g * (ab(k4) * sm)
    errC = g * (
        ab(k3 * (k4 * k4))
        + ab(k4 * (k2 * k5))
        + ab(k4 * (k1 * k6))
        + ab(k7 * (k1 * k2))
    )
    del m, sm

    disc = B * B - 4.0 * (A * C)
    errdisc = (
        g * (B * B + 4.0 * ab(A * C))
        + 2.0 * ab(B) * errB
        + 4.0 * (ab(A) * errC + ab(C) * errA)
    )
    degen = ab(disc) <= errdisc
    has_roots = degen | (disc > 0)
    sq = torch.where(degen, 0.0, vm.sqrt(torch.clamp(disc, min=0.0)))
    dsq = 2.0 * sq + vm.sqrt(errdisc)
    errsq = errdisc / torch.where(dsq == 0, 1.0, dsq)
    # sign(B == +-0) -> +sq: a plain select, not copysign
    q = -0.5 * (B + torch.where(B < 0, -sq, sq))
    errq = 0.5 * (errB + errsq)
    del disc, errdisc, degen, sq, dsq, errsq, B, errB

    neg1 = torch.zeros_like(A, dtype=torch.bool)
    pos1 = torch.zeros_like(A, dtype=torch.bool)
    neg2 = torch.zeros_like(A, dtype=torch.bool)
    pos2 = torch.zeros_like(A, dtype=torch.bool)
    for num, den, errnum, errden in ((q, A, errq, errA), (C, q, errC, errq)):
        root_ok = has_roots & (ab(den) > errden)
        dsafe = torch.where(den == 0, 1.0, den)
        z = num / dsafe
        errz = (errnum + ab(z) * errden) / ab(dsafe)
        del dsafe

        dd = k4 + k7 * z
        errdd = g * (ab(k4) + ab(k7 * z)) + ab(k7) * errz
        dd_ok = ab(dd) > errdd
        ddsafe = torch.where(dd == 0, 1.0, dd)
        y = -(k1 + k5 * z) / ddsafe
        x = -(k2 + k6 * z) / ddsafe
        erry = (
            g * (ab(k1) + ab(k5 * z))
            + ab(k5) * errz
            + ab(y) * errdd
        ) / ab(ddsafe)
        errx = (
            g * (ab(k2) + ab(k6 * z))
            + ab(k6) * errz
            + ab(x) * errdd
        ) / ab(ddsafe)
        del ddsafe

        fv = (
            c000
            + k1 * x + k2 * y + k3 * z
            + k4 * (x * y) + k5 * (x * z) + k6 * (y * z)
            + k7 * ((x * y) * z)
        )
        fmag = (
            ab(c000)
            + ab(k1 * x) + ab(k2 * y) + ab(k3 * z)
            + ab(k4 * (x * y)) + ab(k5 * (x * z))
            + ab(k6 * (y * z)) + ab(k7 * ((x * y) * z))
        )
        gx = ab(k1) + ab(k4 * y) + ab(k5 * z) + ab(k7 * (y * z))
        gy = ab(k2) + ab(k4 * x) + ab(k6 * z) + ab(k7 * (x * z))
        gz = ab(k3) + ab(k5 * x) + ab(k6 * y) + ab(k7 * (x * y))
        tolfv = g * fmag + gx * errx + gy * erry + gz * errz
        del fmag, gx, gy, gz

        ok = (
            root_ok & dd_ok
            & (x > errx) & (x < 1.0 - errx)
            & (y > erry) & (y < 1.0 - erry)
            & (z > errz) & (z < 1.0 - errz)
        )
        # Saddle index: sign of det H = 2 a b c (a = dd), index-2 only when
        # the determinant clears its propagated error bound.
        bb = k5 + k7 * y
        cc = k6 + k7 * x
        errbb = g * (ab(k5) + ab(k7 * y)) + ab(k7) * erry
        errcc = g * (ab(k6) + ab(k7 * x)) + ab(k7) * errx
        det = dd * bb * cc
        errdet = (
            ab(bb * cc) * errdd
            + ab(dd * cc) * errbb
            + ab(dd * bb) * errcc
            + 2.0 * g * ab(det)
        )
        idx2 = det > errdet
        fneg = ok & (fv < -tolfv)
        fpos = ok & (fv > tolfv)
        del x, y, z, errx, erry, errz, dd, errdd, bb, cc, errbb, errcc
        del det, errdet, fv, tolfv, ok, root_ok, dd_ok
        neg1 = neg1 | (fneg & ~idx2)
        pos1 = pos1 | (fpos & ~idx2)
        neg2 = neg2 | (fneg & idx2)
        pos2 = pos2 | (fpos & idx2)
    return neg1, pos1, neg2, pos2


# ---------------------------------------------------------------------------
# Marching squares with explicit ambiguous-face resolution (host Python)
# ---------------------------------------------------------------------------


def _face_segments_resolved(corners, inside, joined):
    """Directed segments for one face; ``joined`` resolves the diagonal
    pattern (True = connect the inside corners across the face).  Same
    conventions as ``mc_tables._face_segments``: corners CCW from outside,
    segments directed with the inside region on the left."""
    bits = [bool(inside[c]) for c in corners]

    def edge(i, j):
        return _EDGE_INDEX[(corners[i % 4], corners[j % 4])]

    n = sum(bits)
    if n == 0 or n == 4:
        return []
    if n == 1:
        i = bits.index(True)
        return [(edge(i, i + 1), edge(i - 1, i))]
    if n == 3:
        j = bits.index(False)
        return [(edge(j - 1, j), edge(j, j + 1))]
    if bits[0] == bits[1]:  # adjacent pair
        i = 0 if bits[0] else 2
        return [(edge(i + 1, i + 2), edge(i - 1, i))]
    if bits[1] == bits[2]:
        i = 1 if bits[1] else 3
        return [(edge(i + 1, i + 2), edge(i - 1, i))]
    # Diagonal pattern.
    if not joined:
        # Separate the inside corners: a cut around each inside corner.
        return [
            (edge(i, i + 1), edge(i - 1, i)) for i in range(4) if bits[i]
        ]
    # Join the inside corners: a cut around each OUTSIDE corner (inverted,
    # like the n == 3 case, keeping inside-on-the-left).
    return [
        (edge(i - 1, i), edge(i, i + 1)) for i in range(4) if not bits[i]
    ]


def loops_of(case, facebits):
    """Closed boundary loops for (case, facebits): list of cyclic cube-edge
    lists in segment direction (inside on the left seen from outside)."""
    inside = [(case >> c) & 1 for c in range(8)]
    amb = ambiguous_faces(case)
    joined = {f: bool((facebits >> r) & 1) for r, f in enumerate(amb)}
    segments = []
    for f, corners in enumerate(_FACES):
        segments.extend(
            _face_segments_resolved(corners, inside, joined.get(f, False))
        )
    if not segments:
        return []
    start_of = {}
    for s in segments:
        assert s[0] not in start_of, (case, facebits, "edge starts twice")
        start_of[s[0]] = s
    loops = []
    unused = set(segments)
    while unused:
        seg = next(iter(unused))
        loop = []
        cur = seg
        while True:
            unused.discard(cur)
            loop.append(cur[0])
            cur = start_of[cur[1]]
            if cur == seg:
                break
        assert len(loop) >= 3, (case, facebits, loop)
        loops.append(loop)
    return loops


# ---------------------------------------------------------------------------
# Trilinear field (numpy on the host) and the bucket keys (torch, float64)
# ---------------------------------------------------------------------------

# Map corner id -> (x, y, z) in {0,1}^3 (CORNER_OFFSETS order).
_C = np.asarray(CORNER_OFFSETS, dtype=np.float64)


def trilinear_coeffs(v):
    """k such that f = k0 + k1 x + k2 y + k3 z + k4 xy + k5 xz + k6 yz
    + k7 xyz matches the 8 corner values.  Vectorized over leading dims of
    ``v`` (..., 8) indexed in CORNER_OFFSETS corner order."""
    v = np.asarray(v, dtype=np.float64)
    c000 = v[..., 0]
    c100 = v[..., 1]
    c110 = v[..., 2]
    c010 = v[..., 3]
    c001 = v[..., 4]
    c101 = v[..., 5]
    c111 = v[..., 6]
    c011 = v[..., 7]
    k0 = c000
    k1 = c100 - c000
    k2 = c010 - c000
    k3 = c001 - c000
    k4 = c110 - c000 - k1 - k2
    k5 = c101 - c000 - k1 - k3
    k6 = c011 - c000 - k2 - k3
    k7 = c111 - c000 - k1 - k2 - k3 - k4 - k5 - k6
    return np.stack([k0, k1, k2, k3, k4, k5, k6, k7], axis=-1)


def trilinear_eval(k, x, y, z):
    """f at (x, y, z): THE evaluation order kernel L1 and its plain
    version repeat (products left to right, the sum left to right)."""
    return (
        k[..., 0]
        + k[..., 1] * x
        + k[..., 2] * y
        + k[..., 3] * z
        + k[..., 4] * x * y
        + k[..., 5] * x * z
        + k[..., 6] * y * z
        + k[..., 7] * x * y * z
    )


def _f64(v, device):
    """``v`` (..., 8) as a float64 tensor: a tensor stays on its device
    unless ``device`` is given; host values go to ``device`` (None: the
    card)."""
    if isinstance(v, torch.Tensor):
        dev = v.device if device is None else torch.device(device)
        return v.to(dev, torch.float64)
    return torch.from_numpy(np.asarray(v, dtype=np.float64)).to(
        resolve_device(device))


def interior_bits(v, device=None):
    """The interior code in [0, 9) (int64), vectorized over (..., 8)
    corner values: ``s1 + 3 * s2`` from the guarded ``interior_flags`` in
    float64, a negative critical value taking priority over a positive one
    per saddle slot.  Equal to the JAX package's numpy oracle bit for bit
    (the CPU square root is numpy's; nothing is divided by a Python
    number)."""
    v = _f64(v, device)
    neg1, pos1, neg2, pos2 = interior_flags(
        tuple(v[..., i] for i in range(8)), torch.finfo(torch.float64).eps
    )
    s1 = torch.where(neg1, 1, torch.where(pos1, 2, 0))
    s2 = torch.where(neg2, 1, torch.where(pos2, 2, 0))
    return (s1 + 3 * s2).to(torch.int64)


def face_joined_bits(v, device=None):
    """Per-face joined bit (..., 6) bool, vectorized over (..., 8) values:
    with CCW corner values (a, b, c, d), ``(a c - b d) * (a + c - b - d) <
    0`` -- the bilinear saddle on the face is inside."""
    v = _f64(v, device)
    bits = []
    for corners in _FACES:
        a, b, c, d = (v[..., i] for i in corners)
        bits.append((a * c - b * d) * (a + c - b - d) < 0.0)
    return torch.stack(bits, dim=-1)


def ext_code(v, case=None, device=None):
    """Extended case code(s) (int64) for (..., 8) corner values."""
    v = _f64(v, device)
    offset = torch.from_numpy(OFFSET).to(v.device)
    weight = torch.from_numpy(WEIGHT).to(v.device)
    if case is None:
        bit = torch.arange(8, device=v.device)
        case = ((v < 0).to(torch.int64) << bit).sum(dim=-1)
    else:
        case = torch.as_tensor(case, dtype=torch.int64).to(v.device)
    fb9 = (face_joined_bits(v) * weight[case]).sum(dim=-1)  # facebits * 9
    return offset[case].to(torch.int64) + fb9 + interior_bits(v)


def _facebits_of(v, case, device=None):
    """The joined bits of the case's ambiguous faces, packed (int64)."""
    v = _f64(v, device)
    w = torch.from_numpy(WEIGHT[case]).to(v.device)
    return (face_joined_bits(v) * w).sum(dim=-1) // 9


# ---------------------------------------------------------------------------
# Kernel L1: the dense oracle's labelling
# ---------------------------------------------------------------------------

# Voxels labelled in one launch (a batch is cut into launches of at most
# this many, one realization at least): 2^24 voxels are 84 MB of workspace
# on the card, and bound the plain version's temporaries on the CPU.
LAUNCH_VOXELS = 2**24


def _corner_index(n):
    """Flat indices of the 8 cube-corner voxels of an n^3 grid, in
    CORNER_OFFSETS order."""
    i, j, l = (CORNER_OFFSETS.astype(np.int64) * (n - 1)).T
    return (i * n + j) * n + l


def _label3d_lib():
    lib = _build.load("label3d", _build.source("label3d.cu"))
    if not getattr(lib, "_sdf_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sdf_label3d.argtypes = [vp, vp, i, i, vp, vp, vp, vp, vp]
        lib.sdf_label3d.restype = ctypes.c_int
        lib._sdf_typed = True
    return lib


def _sample_classes(k, t):
    """``f < 0`` on the grid, (B, n, n, n) bool: ``trilinear_eval``'s ops
    in its order, broadcast over the axes (the values of numpy's meshgrid
    without materialising it)."""
    nb, n = k.shape[0], t.numel()
    x, y, z = t.view(1, n, 1, 1), t.view(1, 1, n, 1), t.view(1, 1, 1, n)
    c = [k[:, i].reshape(nb, 1, 1, 1) for i in range(8)]
    f = (c[0] + c[1] * x + c[2] * y + c[3] * z + c[4] * x * y
         + c[5] * x * z + c[6] * y * z + c[7] * x * y * z)
    return f < 0


def _label_volume_plain(cls):
    """Canonical 6-connected labels of the classes ``cls`` (B, n, n, n)
    bool, (B, n^3) int64: each voxel's label is the smallest flat index of
    its component.  Min-propagation to the fixed point: labels start as
    the flat indices; a step takes every voxel to the smallest label along
    its run of same-class 6-neighbours in each axis in turn (a run's min is
    one scatter), then jumps pointers (a label is a voxel of the same
    component, so ``L[L]`` is one too) until they hold; the steps repeat
    until nothing changes."""
    nb, n = cls.shape[0], cls.shape[1]
    nvox = n ** 3
    runs = []
    for axis in (1, 2, 3):
        c = cls.movedim(axis, -1).contiguous()
        start = torch.ones_like(c)
        start[..., 1:] = c[..., 1:] != c[..., :-1]
        ids = torch.cumsum(start.view(-1), 0) - 1
        runs.append((ids.view(c.shape).movedim(-1, axis).reshape(-1),
                     int(ids[-1]) + 1))
    lab = torch.arange(nvox, device=cls.device).repeat(nb, 1)
    while True:
        old = lab
        for ids, nruns in runs:
            least = torch.full((nruns,), nvox, dtype=torch.int64,
                               device=cls.device)
            least.scatter_reduce_(0, ids, lab.view(-1), "amin")
            lab = least[ids].view(nb, nvox)
        while True:
            jumped = torch.gather(lab, 1, lab)
            if torch.equal(jumped, lab):
                break
            lab = jumped
        if torch.equal(lab, old):
            return lab


def _label_corners_plain(k, t):
    """L1's plain version: ``_sample_classes``, ``_label_volume_plain``,
    and the 8 corners of each."""
    nb, n = k.shape[0], t.numel()
    cls = _sample_classes(k, t).view(nb, n ** 3)
    lab = _label_volume_plain(cls.view(nb, n, n, n))
    at = torch.from_numpy(_corner_index(n)).to(k.device)
    return cls[:, at].to(torch.uint8), lab[:, at].to(torch.int32)


def label_corners(k, t):
    """Kernel L1: label the classes ``f < 0`` / ``f >= 0`` of B sampled
    trilinears with 6-connectivity and return the 8 cube corners' class
    bits (uint8, 1 = ``f < 0``) and labels (int32, the smallest flat index
    ``(i * n + j) * n + l`` of the corner's component), each (B, 8) in
    CORNER_OFFSETS order.

    ``k``: (B, 8) float64 coefficients (``trilinear_coeffs``); ``t``: the
    grid, (n,) float64 (numpy's ``linspace(0, 1, n)``, copied: torch's
    linspace can differ in the last place), on the same device.  A CUDA
    tensor launches ``csrc/label3d.cu`` (its class and label volumes are
    workspace on the card); a CPU tensor runs the plain version."""
    if k.dtype != torch.float64 or t.dtype != torch.float64:
        raise ValueError("label_corners: k and t must be float64")
    if k.dim() != 2 or k.shape[1] != 8 or t.dim() != 1:
        raise ValueError("label_corners: k must be (B, 8) and t (n,)")
    n = t.shape[0]
    if not 2 <= n <= 1290:
        raise ValueError("label_corners: n must lie in [2, 1290] "
                         "(int32 flat indices), got %d" % n)
    if k.device.type == "cpu" and t.device.type == "cpu":
        return _label_corners_plain(k, t)
    _build.require_cuda(k, "label_corners")
    _build.require_cuda(t, "label_corners")
    lib = _label3d_lib()
    nb = k.shape[0]
    out_cls = torch.empty((nb, 8), dtype=torch.uint8, device=k.device)
    out_lab = torch.empty((nb, 8), dtype=torch.int32, device=k.device)
    if nb:
        cls = torch.empty(nb * n ** 3, dtype=torch.uint8, device=k.device)
        lab = torch.empty(nb * n ** 3, dtype=torch.int32, device=k.device)
        _build.check(
            lib.sdf_label3d(k.data_ptr(), t.data_ptr(), n, nb,
                            cls.data_ptr(), lab.data_ptr(),
                            out_cls.data_ptr(), out_lab.data_ptr(),
                            _build.stream_ptr(k.device)),
            "label3d",
        )
        label_corners.launches += 1
        label_corners.labelled[n] = label_corners.labelled.get(n, 0) + nb
    return out_cls, out_lab


# Kernel launches, and realizations labelled by them per n.
label_corners.launches = 0
label_corners.labelled = {}


# ---------------------------------------------------------------------------
# Dense-sampling topology oracle
# ---------------------------------------------------------------------------


def _group_loops(v, loops, cls, lab):
    """Group loops by the (inside, outside) component pair of their edges'
    corners; ``cls``/``lab`` are one realization's 8 corner outputs of
    ``label_corners``.  A corner maps to its label + 1 in its own class and
    to 0 (scipy's background) in the other.  Returns ``(partition,
    None)``, or ``(None, (li, ilabs, olabs))`` for the first loop that
    touches two components."""
    def corner_label(corner, inside):
        return int(lab[corner]) + 1 if bool(cls[corner]) == inside else 0

    groups = {}
    for li, loop in enumerate(loops):
        ilabs, olabs = set(), set()
        for e in loop:
            a, b = EDGE_CORNERS[e]
            cin, cout = (a, b) if v[a] < 0 else (b, a)
            ilabs.add(corner_label(cin, True))
            olabs.add(corner_label(cout, False))
        if len(ilabs) != 1 or len(olabs) != 1:
            return None, (li, ilabs, olabs)
        groups.setdefault((ilabs.pop(), olabs.pop()), []).append(li)
    return tuple(sorted(tuple(sorted(g)) for g in groups.values())), None


def _corner_labels(vs, n, device):
    """Kernel L1 (or its plain version) on the realizations ``vs`` (m, 8)
    at resolution n, in launches of at most LAUNCH_VOXELS voxels; returns
    host arrays (m, 8) of class bits and labels."""
    k = trilinear_coeffs(vs)
    t = torch.from_numpy(np.linspace(0.0, 1.0, n)).to(device)
    per = max(1, LAUNCH_VOXELS // n ** 3)
    cls, lab = [], []
    for s in range(0, len(k), per):
        c, l = label_corners(torch.from_numpy(k[s:s + per]).to(device), t)
        cls.append(c.cpu().numpy())
        lab.append(l.cpu().numpy())
    return np.concatenate(cls), np.concatenate(lab)


def loop_partition(v, loops, n=64, device=None):
    """Group boundary loops by the surface component they bound.

    Samples the trilinear on an n^3 grid, labels inside/outside 3D
    components (6-connectivity; kernel L1 on the card, its plain version
    with ``device="cpu"``), and labels each loop with the
    (inside-component, outside-component) pair it separates -- loops with
    equal labels bound the same surface component (genus-0 pieces in a
    trilinear cell).  Returns a tuple of sorted loop-index groups, e.g.
    ((0,), (1, 2)).  Raises AssertionError when a loop touches two
    components (the grid is too coarse for the feature).
    """
    v = np.asarray(v, dtype=np.float64)
    cls, lab = _corner_labels(v[None], n, resolve_device(device))
    got, fault = _group_loops(v, loops, cls[0], lab[0])
    if fault is not None:
        li, ilabs, olabs = fault
        raise AssertionError(
            f"loop {li} touches multiple 3D components: {ilabs} {olabs} "
            f"(raise oracle resolution n={n})"
        )
    return got


def _partitions_escalating(vs, loops, n0, device):
    """``_partition_escalating`` of each realization of ``vs`` (m, 8),
    batched: all are labelled together at n0, the ones whose loops touch
    two components again together at 2 n0, and so on while n <= 512 (a
    first try at n0 always).  A list of partitions, None where a
    realization still fails: what the one-at-a-time loop gives, as the
    oracle draws nothing at random."""
    out = [None] * len(vs)
    todo = list(range(len(vs)))
    n = n0
    while todo:
        cls, lab = _corner_labels(vs[todo], n, device)
        failed = []
        for row, i in enumerate(todo):
            got, fault = _group_loops(vs[i], loops, cls[row], lab[row])
            if fault is not None:
                failed.append(i)
            else:
                out[i] = got
        todo = failed
        n *= 2
        if n > 512:
            break
    return out


def _partition_escalating(v, loops, n0, device=None):
    """loop_partition with resolution escalation: a feature thinner than
    the oracle grid spacing trips its label-consistency check; double n
    until it resolves.  Returns None for adversarially thin realizations
    that still fail at n=512 (callers drop them and vote on the rest)."""
    v = np.asarray(v, dtype=np.float64)
    return _partitions_escalating(v[None], loops, n0,
                                  resolve_device(device))[0]


# ---------------------------------------------------------------------------
# Triangulation: disks by fan, multi-loop components by bridge-merge + fan
# ---------------------------------------------------------------------------


def _edge_midpoints(v):
    """Crossing position of each cube edge for realization ``v`` (linear
    zero crossing; NaN where the edge does not cross)."""
    va = v[EDGE_CORNERS[:, 0]]
    vb = v[EDGE_CORNERS[:, 1]]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = va / (va - vb)
    t = np.where((va < 0) != (vb < 0), t, np.nan)
    a = _C[EDGE_CORNERS[:, 0]]
    b = _C[EDGE_CORNERS[:, 1]]
    return a + t[:, None] * (b - a)


def _fan(cycle):
    """Fan triangles over a cycle given in surface-boundary direction."""
    return [(cycle[0], cycle[i], cycle[i + 1]) for i in range(1, len(cycle) - 1)]


def triangulate_component(comp_loops, pos):
    """Triangulate one surface component.

    comp_loops: the component's loops in marching-squares segment
    direction (as from ``loops_of``).  Surface-boundary direction is the
    REVERSE: singleton loops use mc_tables' exact fan formula so forced
    cases stay bit-identical between variants; multi-loop components merge
    their reversed loops via bridge edges and fan (same orientation).
    pos: (12, 3) edge crossing positions (geometry for the bridge choice
    only; numpy float distances, as the reference compares them).
    """
    if len(comp_loops) == 1:
        loop = comp_loops[0]
        return [
            (loop[0], loop[i + 1], loop[i]) for i in range(1, len(loop) - 1)
        ]
    # Merge loops into one cycle via bridge edge pairs (each bridge edge
    # appears twice with opposite orientation -> interior manifold edge).
    loops = [list(reversed(lp)) for lp in comp_loops]
    cycle = loops[0]
    rest = loops[1:]
    while rest:
        # nearest (cycle vertex, loop vertex) pair by crossing position
        best = None
        for ri, loop in enumerate(rest):
            for ci, u in enumerate(cycle):
                for lj, w in enumerate(loop):
                    d = float(np.sum((pos[u] - pos[w]) ** 2))
                    if best is None or d < best[0]:
                        best = (d, ri, ci, lj)
        _, ri, ci, lj = best
        loop = rest.pop(ri)
        rot = loop[lj:] + loop[:lj]  # starts at w
        # splice after cycle[ci]: ... u, w, (around loop), w, u, ...
        cycle = cycle[: ci + 1] + rot + [rot[0], cycle[ci]] + cycle[ci + 1:]
    # Fan from a vertex that appears exactly once (any vertex of the first
    # loop other than the bridge endpoints).
    counts = {}
    for e in cycle:
        counts[e] = counts.get(e, 0) + 1
    start = next(i for i, e in enumerate(cycle) if counts[e] == 1)
    cyc = cycle[start:] + cycle[:start]
    tris = _fan(cyc)
    assert all(len({a, b, c}) == 3 for a, b, c in tris), (cyc, tris)
    return tris


# ---------------------------------------------------------------------------
# Table assembly
# ---------------------------------------------------------------------------


def sample_realizations(case, n, rng):
    """(n, 8) corner values with the case's corner signs, log-uniform
    magnitudes in [0.02, 2]: numpy's draws, exp and log on the host
    (``rng`` a ``np.random.Generator``)."""
    mags = np.exp(rng.uniform(np.log(0.02), np.log(2.0), size=(n, 8)))
    signs = np.where(
        [(case >> c) & 1 for c in range(8)], -1.0, 1.0
    )
    return mags * signs


def _vote(parts):
    counts = {}
    for p in parts:
        counts[p] = counts.get(p, 0) + 1
    return counts


def build_tables(samples_per_case=60000, reps_per_bucket=3, oracle_n=64,
                 seed=7, verbose=False, device=None):
    """Derive the full extended table set.  Returns a dict of arrays
    (``tri_table`` (5904, T, 3) int8, ``ntri`` int32, ``offset``,
    ``weight``, ``realizable`` bool, ``ncomp`` int8, ``conflict_rate``
    float32), equal to ``sdf_tpu.core.mc33_build.build_tables`` with the
    same arguments.

    For every base case: sample realizations, bucket them by
    (facebits, interior code), and derive each non-empty bucket's loop
    partition from ``reps_per_bucket`` oracle runs, labelled in one batch.
    If every pick stays unresolved at n=512, 16 more are drawn; if the
    picks disagree, 33 repicks at twice the resolution vote, the majority
    wins and the minority rate goes to ``conflict_rate``.  Buckets never
    observed fall back to an observed interior slot of the same facebits,
    or to the all-disks construction when the facebits combo itself is
    unrealizable.

    Every random number comes from ``np.random.default_rng(seed)`` on the
    host, in the reference's order; the bucket keys are computed on
    ``device`` (None: the card, which raises without one; ``"cpu"`` runs
    the plain versions) and copied back for ``np.unique`` and the draws.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    tri_lists = [None] * N_EXT
    meta_realizable = np.zeros(N_EXT, dtype=bool)
    meta_ncomp = np.zeros(N_EXT, dtype=np.int8)
    conflict_rate = np.zeros(N_EXT, dtype=np.float32)

    for case in range(256):
        amb = ambiguous_faces(case)
        nfb = 1 << len(amb)

        partitions = {}  # (facebits, ibits) -> (partition, representative v)
        if case not in (0, 255):
            v = sample_realizations(case, samples_per_case, rng)
            vt = torch.from_numpy(v).to(device)
            key_all = (_facebits_of(vt, case) * 9
                       + interior_bits(vt)).cpu().numpy()
            del vt
            for key in np.unique(key_all):
                idx = np.flatnonzero(key_all == key)
                fb, ib = int(key) // 9, int(key) % 9
                loops = loops_of(case, fb)
                picks = idx[
                    rng.choice(len(idx), size=min(reps_per_bucket, len(idx)),
                               replace=False)
                ]
                pairs = [(p, pi) for p, pi in zip(
                    _partitions_escalating(v[picks], loops, oracle_n, device),
                    picks) if p is not None]
                if not pairs:
                    # every pick adversarially thin: widen the draw
                    extra = idx[rng.choice(len(idx),
                                           size=min(16, len(idx)),
                                           replace=False)]
                    pairs = [(p, pi) for p, pi in zip(
                        _partitions_escalating(v[extra], loops, oracle_n,
                                               device),
                        extra) if p is not None]
                assert pairs, (case, fb, ib, "no resolvable realization")
                parts = [p for p, _ in pairs]
                picks = np.asarray([pi for _, pi in pairs])
                counts = _vote(parts)
                if len(counts) > 1:
                    # Conflicted bucket: refine the vote with many more
                    # realizations at doubled oracle resolution.
                    repicks = idx[
                        rng.choice(len(idx), size=min(33, len(idx)),
                                   replace=False)
                    ]
                    rp = [(p, pi) for p, pi in zip(
                        _partitions_escalating(v[repicks], loops,
                                               2 * oracle_n, device),
                        repicks) if p is not None]
                    if rp:
                        parts = [p for p, _ in rp]
                        picks = np.asarray([pi for _, pi in rp])
                        counts = _vote(parts)
                best = max(counts, key=counts.get)
                ext = OFFSET[case] + fb * 9 + ib
                conflict_rate[ext] = 1.0 - counts[best] / len(parts)
                rep = v[picks[parts.index(best)]]
                partitions[(fb, ib)] = (best, rep)

        for fb in range(nfb):
            loops = loops_of(case, fb)
            singleton = tuple(sorted((i,) for i in range(len(loops))))
            for ib in range(9):
                ext = OFFSET[case] + fb * 9 + ib
                got = partitions.get((fb, ib))
                if got is not None:
                    meta_realizable[ext] = True
                else:
                    for alt in range(9):  # any observed interior slot
                        got = partitions.get((fb, alt))
                        if got is not None:
                            break
                if got is None:
                    part, vrep = singleton, None  # unrealizable facebits
                else:
                    part, vrep = got
                pos = (_edge_midpoints(vrep) if vrep is not None
                       else _edge_midpoints(_default_realization(case)))
                tris = []
                for group in part:
                    tris.extend(
                        triangulate_component([loops[i] for i in group], pos)
                    )
                tri_lists[ext] = tris
                meta_ncomp[ext] = len(part)
        if verbose and (case % 32 == 0):
            print(f"  case {case}/256 done")

    max_tris = max(len(t) for t in tri_lists)
    tri_table = np.full((N_EXT, max_tris, 3), -1, dtype=np.int8)
    ntri = np.zeros(N_EXT, dtype=np.int32)
    for ext, tris in enumerate(tri_lists):
        ntri[ext] = len(tris)
        for t, tri in enumerate(tris):
            tri_table[ext, t] = tri
    return {
        "tri_table": tri_table,
        "ntri": ntri,
        "offset": OFFSET,
        "weight": WEIGHT,
        "realizable": meta_realizable,
        "ncomp": meta_ncomp,
        "conflict_rate": conflict_rate,
    }


def _default_realization(case):
    """A generic realization of the base case (for bridge geometry of
    unrealizable facebits fallbacks)."""
    rng = np.random.default_rng(case)
    return sample_realizations(case, 1, rng)[0]
