"""The reference mesher against the program's plain versions
(``device="cpu"``): the same triangles, bit for bit, at a size the CPU
meshes quickly, for each configuration at its script's values and at
drawn requests, on the dense route and on the tiles; and what the
comparison makes of a vertex moved by rounding and by more."""

import numpy as np
import pytest
import torch

import check
import sdf_torch
from conftest import SMALL, small_cell
from reference import mesh as ref_mesh
from reference import sdf as ref_sdf
from traffic import Traffic

CASES = [("knurling.edit_2p26", i) for i in range(3)] + [
    ("blobby.edit_2p26", i) for i in range(3)]


def _program_mesh(cell, params, **kw):
    c = cell.config
    return sdf_torch.generate(
        cell.build(sdf_torch, params), samples=SMALL, output="mesh",
        verbose=False, dtype=c["dtype"], sparse=kw.get("sparse", c["sparse"]),
        mc_variant=c["mc_variant"], batch_size=int(c["batch_size"]),
        device="cpu")


@pytest.mark.parametrize("name, request_index", CASES)
def test_reference_equals_program(name, request_index):
    cell = small_cell(name)
    params = Traffic(cell.traffic, cell.config, 77).request(request_index)
    verts, faces = _program_mesh(cell, params)
    ref = ref_mesh.mesh(cell.build(ref_sdf, params), SMALL, "cpu")
    assert len(faces) > 1000
    assert check.compare(verts, faces, ref) == dict.fromkeys(
        cell.config["limits"], 0.0)
    # Every vertex not within check.TOL of a grid point is on an edge due.
    assert 0.9 * len(np.unique(faces)) < len(ref["edges"]) <= len(
        np.unique(faces))


@pytest.mark.parametrize("batch", [8, 4])
def test_reference_equals_the_tiles_route(batch):
    # Small batches, so that the cull keeps few of them and the program's
    # sparse=True routes to the tiles, as blobby does at 2^26.
    cell = small_cell("blobby.edit_2p26")
    cell.config = dict(cell.config, batch_size=batch)
    params = cell.config["params"]
    verts, faces = _program_mesh(cell, params)
    stats = sdf_torch.core.engine.LAST_STATS
    expr = cell.build(ref_sdf, params)
    X, Y, Z, _ = ref_mesh.grid(expr, SMALL)
    skip = ref_mesh.cull(expr, X, Y, Z, torch.float32, "cpu", batch)
    ref = ref_mesh.mesh(expr, SMALL, "cpu", batch=batch)
    assert ref["routed"] == ("auto_tiles" in stats)
    assert ref["routed"] or batch != 4
    assert float(np.mean(skip)) == pytest.approx(
        stats.get("auto_tiles", np.mean(skip)), abs=1e-4)
    got = check.compare(verts, faces, ref)
    assert got["topo_mismatch"] == 0.0 and got["edge_mismatch"] == 0.0


def test_check_sees_one_moved_vertex():
    cell = small_cell("knurling.edit_2p26")
    params = cell.config["params"]
    verts, faces = _program_mesh(cell, params)
    ref = ref_mesh.mesh(cell.build(ref_sdf, params), SMALL, "cpu")
    limits = cell.config["limits"]
    for by, within in ((1e-4, True), (0.3, False)):
        moved = verts.copy()
        moved[faces[0, 0]] += by * ref["step"]
        got = check.compare(moved, faces, ref)
        assert got["vert_gap"] >= by * (1 - 1e-6)
        assert got["count_gap"] == 0
        assert all(got[k] <= limits[k] for k in limits) == within


def test_check_sees_a_hole_and_a_flipped_triangle():
    cell = small_cell("blobby.edit_2p26")
    params = cell.config["params"]
    verts, faces = _program_mesh(cell, params)
    ref = ref_mesh.mesh(cell.build(ref_sdf, params), SMALL, "cpu")
    assert check.compare(verts, faces, ref)["open_edges"] == 0.0
    flipped = faces.copy()
    flipped[7] = flipped[7, ::-1]
    got = check.compare(verts, flipped, ref)
    assert got["open_edges"] == pytest.approx(6 / faces.size)
    assert got["edge_mismatch"] == 0.0 and got["count_gap"] == 0.0
    got = check.compare(verts, faces[1:], ref)
    assert got["open_edges"] == pytest.approx(3 / (faces.size - 3))
    # every triangle turned: a closed surface still, enclosing -V
    got = check.compare(verts, faces[:, ::-1], ref)
    assert got["open_edges"] == 0.0 and got["volume_gap"] == pytest.approx(2)
