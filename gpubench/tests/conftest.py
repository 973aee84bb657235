"""Shared set-up of the benchmark's own tests: the harness's modules and
the repository's root on the import path, and small cells for the CPU."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent.parent), str(HERE.parent)]

import harness  # noqa: E402

SMALL = 2**13


def small_cell(name, **traffic):
    """The cell ``name`` with its traffic cut to a size the CPU meshes in
    a fraction of a second."""
    cell = harness.Cell(name)
    cell.traffic = dict(cell.traffic, samples=SMALL, check_requests=2,
                        trace_requests=2, **traffic)
    return cell


@pytest.fixture
def cuda():
    """Skip where there is no card (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
