"""Mesh format IO for non-STL extensions (counterpart of
``sdf_tpu.io.meshfmt``).

``meshio`` is used when importable; otherwise the built-in OBJ/PLY writers
and readers cover the common cases.  Vertices are dedupped with
``np.unique(..., axis=0)`` into an indexed triangle mesh before writing.
"""

from __future__ import annotations

import numpy as np

from . import stl


def dedup(points):
    """Flat triangle soup (3T, 3) -> indexed mesh (V, 3) float64, (T, 3)
    int32."""
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    verts, inverse = np.unique(points, axis=0, return_inverse=True)
    # int32 faces: the documented generate_mesh contract (np.unique's
    # inverse is int64; triangle counts fit int32 by construction).
    return verts, inverse.reshape(-1, 3).astype(np.int32)


def write_mesh(path, points):
    verts, tris = dedup(points)
    write_indexed(path, verts, tris)


def _unsupported(path):
    return ValueError(
        "unsupported mesh extension %r (built-in: .stl/.obj/.ply; install "
        "meshio for more)" % path
    )


def write_indexed(path, verts, tris):
    lower = path.lower()
    if lower.endswith(".stl"):
        # The in-tree binary writer, so the write API mirrors read_mesh's
        # .stl handling whether or not meshio is present.
        stl.write_binary_stl(path, np.asarray(verts)[np.asarray(tris).ravel()])
        return
    try:
        import meshio
    except ImportError:
        meshio = None
    if meshio is not None:
        meshio.Mesh(verts, [("triangle", tris)]).write(path)
    elif lower.endswith(".obj"):
        _write_obj(path, verts, tris)
    elif lower.endswith(".ply"):
        _write_ply(path, verts, tris)
    else:
        raise _unsupported(path)


def read_mesh(path):
    """Read a mesh; returns (points (V, 3), triangles (T, 3))."""
    lower = path.lower()
    if lower.endswith(".stl"):
        return stl.read_binary_stl(path)
    try:
        import meshio
    except ImportError:
        meshio = None
    if meshio is not None:
        m = meshio.read(path)
        # Pick the triangle block: files may carry line/quad blocks first.
        for block in m.cells:
            if block.type == "triangle":
                return m.points, block.data
        raise ValueError(f"no triangle cells in {path!r}")
    if lower.endswith(".obj"):
        return _read_obj(path)
    if lower.endswith(".ply"):
        return _read_ply(path)
    raise _unsupported(path)


def _write_obj(path, verts, tris):
    with open(path, "w") as fp:
        for v in verts:
            fp.write("v %.9g %.9g %.9g\n" % tuple(v))
        for t in tris:
            fp.write("f %d %d %d\n" % (t[0] + 1, t[1] + 1, t[2] + 1))


def _read_obj(path):
    verts, tris = [], []
    with open(path) as fp:
        for row in fp:
            parts = row.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                # OBJ indices are 1-based; negative values are relative
                # to the vertices read SO FAR (valid per spec).
                idx = [
                    (j - 1) if (j := int(p.split("/")[0])) > 0
                    else len(verts) + j
                    for p in parts[1:]
                ]
                for i in range(1, len(idx) - 1):  # fan for polygons
                    tris.append([idx[0], idx[i], idx[i + 1]])
    return np.array(verts, dtype=np.float64), np.array(tris, dtype=np.int64)


_PLY_FACE = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])


def _write_ply(path, verts, tris):
    with open(path, "wb") as fp:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            "element vertex %d\n"
            "property float x\nproperty float y\nproperty float z\n"
            "element face %d\n"
            "property list uchar int vertex_indices\nend_header\n"
            % (len(verts), len(tris))
        )
        fp.write(header.encode("ascii"))
        fp.write(np.asarray(verts).astype("<f4").tobytes())
        face = np.empty(len(tris), dtype=_PLY_FACE)
        face["n"] = 3
        face["idx"] = tris
        fp.write(face.tobytes())


def _read_ply(path):
    with open(path, "rb") as fp:
        data = fp.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    nv = nf = 0
    binary = False
    for row in header:
        if row.startswith("element vertex"):
            nv = int(row.split()[-1])
        elif row.startswith("element face"):
            nf = int(row.split()[-1])
        elif row.startswith("format binary_little_endian"):
            binary = True
    if not binary:
        raise ValueError("only binary little-endian PLY supported built-in")
    verts = np.frombuffer(data[end: end + nv * 12], dtype="<f4").reshape(-1, 3)
    faces = np.frombuffer(
        data[end + nv * 12: end + nv * 12 + nf * _PLY_FACE.itemsize],
        dtype=_PLY_FACE,
    )
    return verts.astype(np.float64), faces["idx"].astype(np.int64)
