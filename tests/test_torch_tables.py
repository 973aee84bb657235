"""The port's marching-cubes tables are array-equal to sdf_tpu's (exact)."""

import numpy as np
import pytest

from sdf_tpu.core import mc as jmc
from sdf_tpu.core import mc_tables as jt
from sdf_torch.core import mc as tmc
from sdf_torch.core import mc_tables as tt


@pytest.mark.parametrize(
    "name", ["TRI_TABLE", "NTRI_TABLE", "CORNER_OFFSETS", "EDGE_CORNERS", "_FACES"]
)
def test_table_equal(name):
    a = np.asarray(getattr(jt, name))
    b = np.asarray(getattr(tt, name))
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("attr", ["tri", "ntri", "tf3", "eid_pack", "case_bits"])
def test_default_bundle_equal(attr):
    a = getattr(jmc.get_tables("fast"), attr)
    b = getattr(tmc.get_tables("fast"), attr)
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_edge_geometry_equal():
    np.testing.assert_array_equal(tmc._EDGE_AXIS, jmc._EDGE_AXIS)
    np.testing.assert_array_equal(tmc._EDGE_ORIG, jmc._EDGE_ORIG)


def test_round_capacity_equal():
    for n in list(range(0, 200)) + [10**5, 291028, 2**21 + 1]:
        assert tmc.round_capacity(n) == jmc.round_capacity(n)


def test_lewiner_not_ported_yet():
    with pytest.raises(NotImplementedError, match="A5"):
        tmc.get_tables("lewiner")
    with pytest.raises(ValueError):
        tmc.get_tables("nope")
