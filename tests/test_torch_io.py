"""sdf_torch.io.meshfmt against sdf_tpu.io.meshfmt: OBJ and PLY files
written by one package are read back by the other with the same vertices
and faces.  OBJ stores 9 significant digits (float64 vertices within 1e-8
relative), PLY float32 (compared after a float32 round trip); faces equal.
"""

import numpy as np
import pytest
import torch

from sdf_tpu.io import meshfmt as jfmt
import sdf_torch as sp
from sdf_torch.io import meshfmt as tfmt

import torch_helpers as th


@pytest.fixture(scope="module")
def soup():
    return th.example(sp).generate(samples=2**12, verbose=False,
                                   dtype=torch.float64, device="cpu")


def test_dedup_equal(soup):
    vj, fj = jfmt.dedup(soup)
    vt, ft = tfmt.dedup(soup)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    assert ft.dtype == np.int32 and vt.dtype == np.float64
    np.testing.assert_array_equal(vt[ft.reshape(-1)], soup)


def _same_mesh(got, want, ext):
    (vg, fg), (vw, fw) = got, want
    np.testing.assert_array_equal(np.asarray(fg), np.asarray(fw))
    np.testing.assert_array_equal(np.asarray(vg), np.asarray(vw))
    return vg, fg


@pytest.mark.parametrize("ext", [".obj", ".ply", ".stl"])
def test_port_writes_jax_reads(soup, tmp_path, ext):
    path = str(tmp_path / ("mesh" + ext))
    tfmt.write_mesh(path, soup)
    vg, fg = _same_mesh(tfmt.read_mesh(path), jfmt.read_mesh(path), ext)
    verts, tris = tfmt.dedup(soup)
    assert len(fg) == len(tris)
    if ext == ".obj":
        np.testing.assert_array_equal(fg, tris)
        np.testing.assert_allclose(vg, verts, rtol=1e-8, atol=0)
    elif ext == ".ply":
        np.testing.assert_array_equal(fg, tris)
        np.testing.assert_array_equal(
            vg, verts.astype(np.float32).astype(np.float64))


@pytest.mark.parametrize("ext", [".obj", ".ply", ".stl"])
def test_jax_writes_port_reads(soup, tmp_path, ext):
    path = str(tmp_path / ("mesh" + ext))
    jfmt.write_mesh(path, soup)
    _same_mesh(tfmt.read_mesh(path), jfmt.read_mesh(path), ext)


@pytest.mark.parametrize("ext", [".obj", ".ply"])
def test_files_are_byte_equal(soup, tmp_path, ext):
    a, b = str(tmp_path / ("a" + ext)), str(tmp_path / ("b" + ext))
    tfmt.write_mesh(a, soup)
    jfmt.write_mesh(b, soup)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_obj_reader_takes_polygons_and_relative_indices(tmp_path):
    path = str(tmp_path / "quad.obj")
    with open(path, "w") as fp:
        fp.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n\nf 1/1 2/2 3/3 4/4\n"
                 "f -4 -3 -2\n")
    _same_mesh(tfmt.read_mesh(path), jfmt.read_mesh(path), ".obj")
    assert tfmt.read_mesh(path)[1].tolist() == [[0, 1, 2], [0, 2, 3], [0, 1, 2]]


def test_unsupported_extension_raises(soup, tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        tfmt.write_mesh(str(tmp_path / "mesh.xyz"), soup)
    with pytest.raises(ValueError, match="unsupported"):
        tfmt.read_mesh(str(tmp_path / "mesh.xyz"))


def test_ascii_ply_is_refused(tmp_path):
    path = str(tmp_path / "a.ply")
    with open(path, "wb") as fp:
        fp.write(b"ply\nformat ascii 1.0\nelement vertex 0\nelement face 0\n"
                 b"end_header\n")
    with pytest.raises(ValueError, match="binary"):
        tfmt.read_mesh(path)
