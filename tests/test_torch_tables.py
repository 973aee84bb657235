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
    """The lewiner bundle loads (a name kept from when it did not); an
    unknown variant name raises."""
    assert tmc.get_tables("lewiner").name == "lewiner"
    assert tmc.get_tables("fast") is tmc.get_tables("default")
    with pytest.raises(ValueError):
        tmc.get_tables("nope")


def test_mc33_npz_is_a_byte_copy():
    import sdf_torch.core.mc33 as tm33
    import sdf_tpu.core.mc33 as jm33

    with open(tm33._NPZ, "rb") as a, open(jm33._NPZ, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert len(data) == 11116


@pytest.mark.parametrize("name", ["OFFSET", "WEIGHT", "N_EXT", "GUARD_ULPS"])
def test_mc33_layout_equal(name):
    from sdf_tpu.core import mc33_build as jb
    from sdf_torch.core import mc33_build as tb

    np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))
    for case in (0, 5, 90, 165, 255):
        assert tb.ambiguous_faces(case) == jb.ambiguous_faces(case)


@pytest.mark.parametrize(
    "key", ["tri_table", "ntri", "offset", "weight", "realizable", "ncomp",
            "conflict_rate"])
def test_mc33_loaded_tables_equal(key):
    from sdf_tpu.core import mc33 as jm33
    from sdf_torch.core import mc33 as tm33

    a, b = jm33.load_tables()[key], tm33.load_tables()[key]
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize(
    "attr", ["tri", "ntri", "tf3", "eid_pack", "case_bits", "max_tris",
             "ncase"])
def test_lewiner_bundle_equal(attr):
    a = getattr(jmc.get_tables("lewiner"), attr)
    b = getattr(tmc.get_tables("lewiner"), attr)
    np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    want = {"case_bits": 13, "max_tris": 10, "ncase": 5904}.get(attr)
    if want is not None:
        assert b == want


def test_lewiner_empty_entries_are_per_table():
    """Which codes emit no triangle is per table: under lewiner more than
    the codes of cases 0 and 255 are empty, so count_indexed keys activity
    on ntri > 0, not on the 8-bit case."""
    from sdf_torch.core import mc33_build as tb

    ntri = tmc.get_tables("lewiner").ntri
    empty = set(np.nonzero(ntri == 0)[0].tolist())
    forced = set(range(9)) | set(range(int(tb.OFFSET[255]), tb.N_EXT))
    assert forced <= empty
    np.testing.assert_array_equal(ntri, jmc.get_tables("lewiner").ntri)
