"""The frozen work a sample of each configuration costs, recomputed from
the reference expression (``reference/work.py``), and the samples and
cells that kept tiles cover."""

import numpy as np
import pytest

import harness
from reference import mesh as ref_mesh
from reference import sdf as ref_sdf
from reference import work


@pytest.mark.parametrize("config", ["knurling", "blobby"])
def test_frozen_flops_per_sample(config):
    cell = harness.Cell({"knurling": "knurling.edit_2p26",
                         "blobby": "blobby.edit_2p26"}[config])
    expr = cell.build(ref_sdf, cell.config["params"])
    total, ops = work.flops_per_sample(expr)
    assert total == cell.config["work"]["flops_per_sample"], ops
    # at any draw too: the draw moves values, not operations
    scaled = {k: 1.05 * v for k, v in cell.config["params"].items()}
    assert work.flops_per_sample(cell.build(ref_sdf, scaled))[0] == total


def test_tile_cover_counts_shared_samples_once():
    keep = np.zeros((3, 2, 1), dtype=bool)
    shape = (70, 40, 20)  # batches of 32 cells: 3 x 2 x 1, the last cut
    assert ref_mesh.tile_cover(keep, shape, 32) == {"tile_samples": 0,
                                                    "tile_cells": 0}
    keep[0, 0, 0] = True
    assert ref_mesh.tile_cover(keep, shape, 32) == {
        "tile_samples": 33 * 33 * 20, "tile_cells": 32 * 32 * 19}
    keep[1, 0, 0] = True  # shares the face x = 32 with the first
    assert ref_mesh.tile_cover(keep, shape, 32) == {
        "tile_samples": 65 * 33 * 20, "tile_cells": 64 * 32 * 19}
    keep[:] = True
    assert ref_mesh.tile_cover(keep, shape, 32) == {
        "tile_samples": 70 * 40 * 20, "tile_cells": 69 * 39 * 19}
