"""A run with the timed path broken underneath has to come out not
correct: the control (the reference with a bfloat16 field in the
program's place) and each fault a cell can have; the witness (the
reference with a float64 field rounded to float32 and a grid moved by one
float32 ulp) has to come out correct.  Everything of a run but the look
for a card runs, on the CPU at a small size."""

import numpy as np
import pytest

import harness
from conftest import small_cell
from control import Control

CELLS = ["knurling.edit_2p26", "blobby.edit_2p26"]


class Stale(harness.Program):
    """Returns the previous request's mesh: a state left unchanged."""

    last = None

    def __call__(self, params):
        got, self.last = self.last, super().__call__(params)
        return got if got is not None else self.last


class Half(harness.Program):
    """Leaves half of the triangles out."""

    def __call__(self, params):
        verts, faces = super().__call__(params)
        return verts, faces[: len(faces) // 2]


class Altered(harness.Program):
    """Moves one vertex of each mesh where it is produced, by the mesh's
    median edge on each axis."""

    def __call__(self, params):
        verts, faces = super().__call__(params)
        verts = verts.copy()
        edge = np.linalg.norm(np.diff(verts[faces[:, :2]], axis=1), axis=2)
        verts[faces[len(faces) // 2, 0]] += np.median(edge)
        return verts, faces


def _run(cell, program):
    result, rows = harness.run(cell, 2**31 + 7, 1.0, False, "cpu",
                               program=program)
    assert [r[0] for r in rows][:1] == ["checked_requests"]
    assert list(result)[-1] == "checks"
    return result


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    cell = small_cell(name)
    assert _run(cell, harness.Program(cell, "cpu"))["correct"] is True


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    result = _run(cell, Control(cell, "cpu"))
    assert result["correct"] is False
    assert result["checks"]["topo_mismatch"]["value"] > 0.01


@pytest.mark.parametrize("name", CELLS)
def test_witness_is_correct(name):
    cell = small_cell(name)
    result = _run(cell, Control(cell, "cpu", "witness"))
    assert result["correct"] is True
    assert result["checks"]["vert_gap"]["value"] > 0


@pytest.mark.parametrize("fault", [Stale, Half, Altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    cell = small_cell(name)
    result = _run(cell, fault(cell, "cpu"))
    assert result["correct"] is False


class Unreadable(harness.Program):
    """Returns a vertex that is not a number."""

    def __call__(self, params):
        verts, faces = super().__call__(params)
        verts = verts.copy()
        verts[faces[0, 0]] = np.nan
        return verts, faces


def test_unreadable_answer_is_not_correct():
    cell = small_cell("blobby.edit_2p26")
    result = _run(cell, Unreadable(cell, "cpu"))
    assert result["correct"] is False
    assert result["checks"]["vert_gap"]["value"] == harness.UNREADABLE
