"""The runtime part of the lewiner (trilinear-faithful) table derivation
(counterpart of ``sdf_tpu.core.mc33_build``): the layout of the extended
case code and the guarded interior test.

``ext = OFFSET[case] + facebits * 9 + ibits`` where ``case`` is the 8-bit
corner-sign code, ``facebits`` packs one *joined* bit per ambiguous face of
the case (set iff the bilinear saddle on that face is inside: Lewiner's face
test) and ``ibits = s1 + 3 * s2`` in [0, 9) describes the trilinear's two
body saddles (``s1`` the index-1 saddle, ``s2`` the index-2 one: 0 = absent
or outside the open cell, 1 = inside with a negative critical value, 2 =
inside with a positive one).  ``sum_case 2^n_ambiguous(case) * 9 = 5904``
codes in all: OFFSET reaches 5,895 and a WEIGHT at most 288 (= 9 * 2^5).

The table derivation itself (boundary loops, the scipy topology oracle, the
triangulation) is not runtime code and is not ported: the committed
``mc33_tables.npz`` is a byte-for-byte copy of the JAX package's, and
``mc33.load_tables`` checks it against ``build_offsets`` below.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import vecmath as vm
from .mc_tables import _FACES


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
