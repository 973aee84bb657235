"""Binary STL writer/reader (counterpart of ``sdf_tpu.io.stl``).

Record layout per the STL spec: 80-byte zero header, uint32 triangle count,
then per triangle a float32 normal (from the face cross product), 3 float32
vertices and a zero uint16 attribute.
"""

from __future__ import annotations

import struct

import numpy as np

_RECORD = np.dtype(
    [
        ("normal", ("<f", 3)),
        ("points", ("<f", (3, 3))),
        ("attr", "<H"),
    ]
)


def write_binary_stl(path, points):
    n = len(points) // 3

    points = np.asarray(points, dtype="float32").reshape((-1, 3, 3))
    normals = np.cross(points[:, 1] - points[:, 0], points[:, 2] - points[:, 0])
    norm = np.linalg.norm(normals, axis=1).reshape((-1, 1))
    normals = normals / np.where(norm == 0, 1, norm)  # guard degenerate faces

    a = np.zeros(n, dtype=_RECORD)
    a["points"] = points
    a["normal"] = normals

    with open(path, "wb") as fp:
        fp.write(b"\x00" * 80)
        fp.write(struct.pack("<I", n))
        fp.write(a.tobytes())


def read_binary_stl(path):
    """Read a binary STL; returns (points (V, 3), triangles (T, 3) indices)."""
    with open(path, "rb") as fp:
        data = fp.read()
    n = struct.unpack("<I", data[80:84])[0]
    if len(data) < 84 + n * _RECORD.itemsize:
        if data[:5] == b"solid" and b"facet" in data[:1024]:
            raise ValueError(
                "%r is an ASCII STL; only binary STL is supported" % path
            )
        raise ValueError("truncated binary STL %r" % path)
    a = np.frombuffer(data[84: 84 + n * _RECORD.itemsize], dtype=_RECORD)
    from . import meshfmt

    return meshfmt.dedup(a["points"].reshape(-1, 3).astype(np.float64))
