"""Host-side assembly of a rank's indexed mesh (counterpart of
``sdf_tpu.parallel.shards``).

Both sharded pipelines (z slabs, ``parallel.grid``; the tile list,
``parallel.sparse``) emit the same layout on each rank: ``everts (3,
edge_capacity)`` unique per-edge vertices, ``faces (3, capacity)`` int32
indices into them, of which the first ``nedge`` and ``count`` are valid.
A rank reads back only its own shard, trimmed on the device; its soup is
rebuilt here bit-identically to the single-device emit.  Assemble across
ranks with ``parallel.gather_triangles``.
"""

from __future__ import annotations

import numpy as np

from ..core import node


def assemble_indexed(everts, faces, count, nedge, return_indexed):
    """Trim this rank's indexed emit to ``nedge`` vertices and ``count``
    triangles and read it back (one transfer).  Returns ``(verts (V, 3)
    float64, faces (T, 3) int32)`` when ``return_indexed``, otherwise the
    ``(3T, 3)`` float64 triangle soup."""
    eh, fh = node.fetch([everts[:, :nedge], faces[:, :count]])
    verts = eh.astype(np.float64).T
    tris = fh.T.astype(np.int32)
    if return_indexed:
        return verts, tris
    return verts[tris.reshape(-1)]
