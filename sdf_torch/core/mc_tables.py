"""Marching-cubes case tables, generated correct-by-construction at import.

The reference delegates isosurfacing to ``skimage.measure.marching_cubes``
(ref sdf/core.py:3,16-18).  Here the per-cell triangulation table is *derived*
rather than transcribed:

  1. For each of the 256 corner sign configurations, run marching squares on
     each of the six cube faces.  Faces are oriented with corners CCW as seen
     from outside the cube; segments are directed so the inside (negative)
     region lies on the left.  The ambiguous diagonal pattern always keeps
     the inside corners separated -- a fixed combinatorial rule, so the two
     cells sharing a face always make the same decision and the global mesh
     is watertight by construction (no classic-MC hole problem).
  2. The directed face segments chain into closed loops over the cube's
     crossing edges (asserted during generation).
  3. Each loop is fan-triangulated.

The result is a ``(256, MAX_TRIS, 3)`` int32 table of cube-edge indices plus
a ``(256,)`` triangle count table, consumed by the device kernel in
``sdf_torch.core.mc``.  A verbatim copy of the JAX package's table
derivation (tests/test_torch_tables.py holds the two array-equal).

Conventions:
  * corner ``c`` of cell ``(i, j, k)`` sits at ``(i, j, k) + CORNER_OFFSETS[c]``
  * case bit ``c`` is set iff ``volume[corner c] < level``
  * vertices lie on crossing edges at the linear zero crossing
  * triangle winding gives outward normals (away from the negative region)
"""

from __future__ import annotations

import numpy as np

# Corner numbering (x, y, z offsets); bit c of a case index = corner c inside.
CORNER_OFFSETS = np.array(
    [
        (0, 0, 0),
        (1, 0, 0),
        (1, 1, 0),
        (0, 1, 0),
        (0, 0, 1),
        (1, 0, 1),
        (1, 1, 1),
        (0, 1, 1),
    ],
    dtype=np.int32,
)

# The 12 cube edges as (corner_a, corner_b).  Endpoint order is canonical --
# corner_a is the coordinate-wise smaller corner -- so that the two cells
# sharing a face interpolate a shared crossing vertex in the SAME direction
# and produce bit-identical float32 positions (seam watertightness).
EDGE_CORNERS = np.array(
    [
        (0, 1),
        (1, 2),
        (3, 2),
        (0, 3),
        (4, 5),
        (5, 6),
        (7, 6),
        (4, 7),
        (0, 4),
        (1, 5),
        (2, 6),
        (3, 7),
    ],
    dtype=np.int32,
)

# Each face's 4 corners, CCW as seen from outside the cube.
_FACES = [
    [0, 3, 2, 1],  # z = 0
    [4, 5, 6, 7],  # z = 1
    [0, 1, 5, 4],  # y = 0
    [3, 7, 6, 2],  # y = 1
    [0, 4, 7, 3],  # x = 0
    [1, 2, 6, 5],  # x = 1
]

_EDGE_INDEX = {}
for _e, (_a, _b) in enumerate(EDGE_CORNERS):
    _EDGE_INDEX[(int(_a), int(_b))] = _e
    _EDGE_INDEX[(int(_b), int(_a))] = _e


def _face_segments(corners, inside):
    """Directed marching-squares segments for one face.

    ``corners``: the face's 4 cube-corner ids, CCW from outside.
    ``inside``: 8 bools.  Returns a list of (start_edge, end_edge) cube-edge
    pairs, directed with the inside region on the left (seen from outside).
    """
    bits = [bool(inside[c]) for c in corners]

    def edge(i, j):
        return _EDGE_INDEX[(corners[i % 4], corners[j % 4])]

    n = sum(bits)
    if n == 0 or n == 4:
        return []
    if n == 1:
        i = bits.index(True)
        # Corner cut: from the edge after the corner to the edge before it.
        return [(edge(i, i + 1), edge(i - 1, i))]
    if n == 3:
        j = bits.index(False)
        # Inverted corner cut around the single outside corner.
        return [(edge(j - 1, j), edge(j, j + 1))]
    # n == 2
    if bits[0] == bits[1]:  # adjacent pair (0,1) or (2,3)
        i = 0 if bits[0] else 2
        return [(edge(i + 1, i + 2), edge(i - 1, i))]
    if bits[1] == bits[2]:  # adjacent pair (1,2) or (3,0)
        i = 1 if bits[1] else 3
        return [(edge(i + 1, i + 2), edge(i - 1, i))]
    # Diagonal (ambiguous) pattern: always keep the two inside corners
    # separated.  Purely combinatorial, hence identical from both sides of
    # the face -> watertight.
    segs = []
    for i in range(4):
        if bits[i]:
            segs.append((edge(i, i + 1), edge(i - 1, i)))
    return segs


def _triangulate(case):
    """All triangles (as cube-edge index triples) for one case."""
    inside = [(case >> c) & 1 for c in range(8)]
    segments = []
    for corners in _FACES:
        segments.extend(_face_segments(corners, inside))
    if not segments:
        return []

    start_of = {}
    end_of = {}
    for s in segments:
        a, b = s
        assert a not in start_of, f"case {case}: edge {a} starts two segments"
        assert b not in end_of, f"case {case}: edge {b} ends two segments"
        start_of[a] = s
        end_of[b] = s
    assert set(start_of) == set(end_of), f"case {case}: open chains"

    triangles = []
    unused = set(segments)
    while unused:
        seg = next(iter(unused))
        loop = []
        cur = seg
        while True:
            unused.discard(cur)
            loop.append(cur[0])
            nxt = start_of[cur[1]]
            if nxt == seg:
                break
            cur = nxt
        assert len(loop) >= 3, f"case {case}: degenerate loop {loop}"
        for i in range(1, len(loop) - 1):
            # Reversed fan order: the loop runs with the inside region on the
            # left seen from outside the cube, which makes the *reversed*
            # winding the one whose right-hand-rule normal points outward
            # (validated against analytic spheres in tests).
            triangles.append((loop[0], loop[i + 1], loop[i]))
    return triangles


def _build_tables():
    all_tris = [_triangulate(case) for case in range(256)]
    max_tris = max(len(t) for t in all_tris)
    tri_table = np.full((256, max_tris, 3), -1, dtype=np.int32)
    ntri_table = np.zeros((256,), dtype=np.int32)
    for case, tris in enumerate(all_tris):
        ntri_table[case] = len(tris)
        for t, tri in enumerate(tris):
            tri_table[case, t] = tri
    return tri_table, ntri_table


TRI_TABLE, NTRI_TABLE = _build_tables()
MAX_TRIS_PER_CELL = TRI_TABLE.shape[1]
