"""Extended-case (lewiner) classification: sdf_torch.core.mc33 on CPU
tensors (the plain versions of kernel B2) against sdf_tpu.core.mc33.

The JAX function is evaluated EAGERLY (``jax.disable_jit()``): jitted XLA on
the CPU contracts multiply-adds into FMAs, and the order of evaluation is
this code's contract.  Tolerance: every ext code bit-equal, in float32 and
float64; in float64 also equal to the numpy oracle
``sdf_tpu.core.mc33_build.ext_code``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
from sdf_tpu.core import engine as jengine
from sdf_tpu.core import mc33 as jm
from sdf_tpu.core import mc33_build as jb
from sdf_tpu.core.node import cast as jcast
from sdf_torch.core import mc33 as tm
from sdf_torch.core import mc33_build as tb

import torch_helpers as th


def _jax_eager(vol, level=0.0, base_case=None):
    bc = None if base_case is None else jnp.asarray(base_case)
    with jax.disable_jit():
        return np.asarray(jm._classify_ext_jit(jnp.asarray(vol), level, bc))


def _port(vol, level=0.0, base_case=None):
    bc = None if base_case is None else torch.as_tensor(base_case)
    out = tm.classify_ext(torch.as_tensor(vol), level, bc)
    assert out.dtype == torch.int32
    return out.numpy()


def _corner_rows(vol, level=0.0):
    """(ncells, 8) float64 corner values in CORNER_OFFSETS order."""
    nx, ny, nz = vol.shape
    return np.stack(
        [vol[ox: nx - 1 + ox, oy: ny - 1 + oy, oz: nz - 1 + oz] - level
         for ox, oy, oz in np.asarray(jb.CORNER_OFFSETS)], axis=-1,
    ).reshape(-1, 8)


def _case_of(vol, level=0.0):
    rows = _corner_rows(vol, level)
    return ((rows < 0) << np.arange(8)).sum(axis=-1).astype(np.int32).reshape(
        tuple(n - 1 for n in vol.shape))


# --- the table part ------------------------------------------------------------


def test_offsets_state_their_true_range():
    """OFFSET reaches 5,895, a WEIGHT at most 288, 5,904 codes in all."""
    assert int(tb.OFFSET.max()) == 5895
    assert int(tb.WEIGHT.max()) == 288
    assert tb.N_EXT == 5904 == jb.N_EXT


def test_ext_from_bits_full_domain():
    """256 cases x 64 facebits x 9 ibits, against the XLA form and against
    the Pallas kernel in interpret mode."""
    extras = np.asarray(
        [fb | (ib << 6) for ib in range(9) for fb in range(64)], np.int32
    )
    c_all = np.repeat(np.arange(256), len(extras)).astype(np.int32)
    e_all = np.tile(extras, 256)
    got = tm.ext_from_bits(torch.as_tensor(c_all), torch.as_tensor(e_all))
    assert got.dtype == torch.int32
    want = np.asarray(jm.ext_from_bits(jnp.asarray(c_all), jnp.asarray(e_all)))
    np.testing.assert_array_equal(got.numpy(), want)
    kern = np.asarray(jm._ext_from_bits_kernel(
        jnp.asarray(c_all), jnp.asarray(e_all), _interpret=True))
    np.testing.assert_array_equal(got.numpy(), kern)
    assert 0 <= got.min() and got.max() == 5903


def test_ext_from_bits_ragged_tail():
    rng = np.random.RandomState(3)
    c = rng.randint(0, 256, 20000).astype(np.int32)
    e = rng.randint(0, 256, 20000).astype(np.int32)
    got = tm.ext_from_bits(torch.as_tensor(c), torch.as_tensor(e)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jm.ext_from_bits(jnp.asarray(c), jnp.asarray(e))))
    np.testing.assert_array_equal(
        got, np.asarray(jm._ext_from_bits_kernel(
            jnp.asarray(c), jnp.asarray(e), _interpret=True)))
    # grid-shaped inputs keep their shape
    g = tm.ext_from_bits(torch.as_tensor(c[:1000].reshape(10, 10, 10)),
                         torch.as_tensor(e[:1000].reshape(10, 10, 10)))
    np.testing.assert_array_equal(g.numpy().reshape(-1), got[:1000])


def test_ext_from_bits_case_outside_the_table():
    """A case outside [0, 256) contributes no offset and no weight, as the
    one-hot form gives."""
    c = np.array([-1, 256, 4095, 3], np.int32)
    e = np.array([63 | (5 << 6)] * 4, np.int32)
    got = tm.ext_from_bits(torch.as_tensor(c), torch.as_tensor(e)).numpy()
    want = np.asarray(jm.ext_from_bits(jnp.asarray(c), jnp.asarray(e)))
    np.testing.assert_array_equal(got, want)
    assert list(got[:3]) == [5, 5, 5]


def test_ext_from_bits_refuses_other_types():
    c = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        tm.ext_from_bits(c, c)
    with pytest.raises(ValueError):
        tm.ext_from_bits(torch.zeros(4, dtype=torch.int32),
                         torch.zeros(5, dtype=torch.int32))


# --- the float part ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_extra_bits_random_volume(dtype):
    vol = np.random.default_rng(5).standard_normal((12, 11, 13)).astype(dtype)
    with jax.disable_jit():
        want = np.asarray(jm.extra_bits(jm._corners(jnp.asarray(vol))))
    got = tm.extra_bits(tm._corners(torch.as_tensor(vol)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want >> 6)) > 1  # interior codes do occur


@pytest.mark.parametrize("level", [0.0, 0.125])
@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_classify_ext_random_volume(dtype, with_base, level):
    vol = np.random.default_rng(11).standard_normal((12, 11, 13)).astype(dtype)
    base = _case_of(vol, np.asarray(level, dtype)) if with_base else None
    want = _jax_eager(vol, level, base)
    got = _port(vol, level, base)
    np.testing.assert_array_equal(got, want)
    if dtype == "float64":
        oracle = jb.ext_code(_corner_rows(vol, level)).reshape(got.shape)
        np.testing.assert_array_equal(got, oracle)
    assert got.min() >= 0 and got.max() < 5904


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_classify_ext_leading_batch_dim(dtype):
    vol = np.random.default_rng(2).standard_normal((3, 6, 7, 5)).astype(dtype)
    got = _port(vol)
    assert got.shape == (3, 5, 6, 4)
    np.testing.assert_array_equal(got, _jax_eager(vol))
    for b in range(3):
        np.testing.assert_array_equal(got[b], _port(vol[b]))


@pytest.mark.parametrize("variant", ["lewiner", "fast"])
def test_tables_classify_per_variant(variant):
    """``Tables.classify``: the 8-bit case grid under fast, the extended
    codes under lewiner, equal to the JAX bundle's (eager)."""
    from sdf_tpu.core import mc as jmc
    from sdf_torch.core import mc as tmc

    vol = np.random.default_rng(4).standard_normal((9, 10, 8))
    with jax.disable_jit():
        want = np.asarray(jmc.get_tables(variant).classify(jnp.asarray(vol), 0.25))
    got = tmc.get_tables(variant).classify(torch.as_tensor(vol), 0.25).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.max() > 255) == (variant == "lewiner")


# Degenerate cells harvested from the example model at step 0.04
# (grid-aligned CSG: flat faces make the interior test's quadratic an exact
# boundary double root).  Corner order: CORNER_OFFSETS.
_DEGENERATE_CELLS = [
    [0.3580868897091918, 0.3258959235173755, 0.3113351974228378,
     0.3499999999999992, 0.3499999999999992, 0.30999999999999517,
     0.30999999999999517, 0.3499999999999992],
    [-0.05000000000000071, -0.08309518948453065, -0.04332310828824326,
     -0.04332310828824326, -0.05000000000000071, -0.0803447251418774,
     -0.040370243444249, -0.040370243444249],
    [0.3499999999999992, 0.3499999999999992, 0.3499999999999992,
     0.35572858640658467, 0.30999999999999517, 0.30999999999999517,
     0.30999999999999517, 0.32348026052524403],
    [0.23336936884292925, 0.2300000000000022, 0.2300000000000022,
     0.2300000000000022, 0.27000000000000046, 0.27000000000000046,
     0.27000000000000046, 0.27000000000000046],
    [0.23923190379189396, 0.23923190379189574, 0.23923190379189574,
     0.19933407243254475, 0.2331667187174724, 0.23316671871747374,
     0.23316671871747374, 0.19405882918443362],
    [0.11337325277733967, 0.11767616061182906, 0.08719823399415105,
     0.08277421469112767, 0.10999999999999943, 0.10999999999999943,
     0.0699999999999994, 0.0699999999999994],
    [0.20470353879533149, 0.18999999999999995, 0.16894109285506342,
     0.20470353879533149, 0.22143223445631932, 0.18999999999999995,
     0.183772233983162, 0.22143223445631932],
    [-0.0035871324805683003, -0.043323108288245926, -0.00999999999999801,
     -0.0035871324805683003, -0.009901951359280403, -0.04918120870983955,
     -0.00999999999999801, -0.009901951359280403],
    [0.2729493312775664, 0.30999999999999517, 0.3174217244299484,
     0.28545711713771027, 0.27000000000000046, 0.30999999999999517,
     0.30999999999999517, 0.27000000000000046],
]

# Engineered exact interior tie: f = 1 - x - y - z + 4 x y z has a critical
# point exactly at the cell centre with critical value exactly 0; the strict
# inequality on the exact value means NO tunnel.  The scaled variants make
# the arithmetic inexact, so the decision rides on the deadband.
_TIE_CELL = [1.0, 0.0, -1.0, 0.0, 0.0, -1.0, 2.0, -1.0]
_TIE_SCALES = [1.0, 0.1, 1 / 3, np.pi / 10]


def _vol_of(v8, dtype):
    vol = np.zeros((2, 2, 2), dtype)
    for ci, (ox, oy, oz) in enumerate(np.asarray(jb.CORNER_OFFSETS)):
        vol[ox, oy, oz] = v8[ci]
    return vol


def _special_cells():
    cells = [(("degenerate%d" % i), v) for i, v in enumerate(_DEGENERATE_CELLS)]
    cells += [("tie*%.4g" % s, [x * s for x in _TIE_CELL]) for s in _TIE_SCALES]
    return cells


@pytest.mark.parametrize("name,v", _special_cells(),
                         ids=[n for n, _ in _special_cells()])
def test_degenerate_and_tie_cells(name, v):
    """float64 equal to the oracle (and to eager JAX); float32 equal to
    eager JAX."""
    ref = int(jb.ext_code(np.asarray(v, np.float64)[None])[0])
    v64 = _vol_of(v, np.float64)
    assert int(_port(v64)[0, 0, 0]) == ref
    assert int(_jax_eager(v64)[0, 0, 0]) == ref
    v32 = _vol_of(v, np.float32)
    assert int(_port(v32)[0, 0, 0]) == int(_jax_eager(v32)[0, 0, 0])
    if name.startswith("tie"):
        assert int(tm.extra_bits(tm._corners(torch.as_tensor(v64)))[0, 0, 0]) >> 6 == 0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_example_volume_ext_grid(dtype):
    """The example model's volume at step 0.04 (the grid-aligned CSG workload
    that is rich in degenerate cells), the JAX volume fed to both."""
    jd = getattr(jnp, dtype)
    X = np.arange(-1.1, 1.1, 0.04)
    vol = np.array(jengine._eval_volume(jcast(th.example(st), jd), X, X, X, jd))
    got = _port(vol)
    np.testing.assert_array_equal(got, _jax_eager(vol))
    if dtype == "float64":
        np.testing.assert_array_equal(
            got, jb.ext_code(_corner_rows(vol)).reshape(got.shape))
    base = _case_of(vol)
    np.testing.assert_array_equal(_port(vol, 0.0, base), got)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_nan_inf_and_exact_zero_volumes(dtype):
    """NaN (0/0 at an ellipsoid's centre), +-inf and exact zeros reach this
    code: every comparison with NaN is false and the one maximum passes NaN
    on, as in JAX."""
    rng = np.random.default_rng(7)
    vol = rng.standard_normal((9, 10, 8)).astype(dtype)
    flat = vol.reshape(-1)
    idx = rng.permutation(flat.size)
    flat[idx[:25]] = np.nan
    flat[idx[25:40]] = np.inf
    flat[idx[40:55]] = -np.inf
    flat[idx[55:120]] = 0.0
    flat[idx[120:140]] = -0.0
    np.testing.assert_array_equal(_port(vol), _jax_eager(vol))
    vol[2:5] = 0.0  # whole flat slabs: every coefficient exactly zero
    np.testing.assert_array_equal(_port(vol), _jax_eager(vol))
    base = _case_of(np.nan_to_num(vol.astype(np.float64)))
    np.testing.assert_array_equal(_port(vol, 0.0, base),
                                  _jax_eager(vol, 0.0, base))


def test_classify_ext_refuses_bad_inputs():
    v = torch.zeros((4, 4, 4), dtype=torch.float32)
    with pytest.raises(ValueError):
        tm.classify_ext(v.to(torch.float16))
    with pytest.raises(ValueError):
        tm.classify_ext(torch.zeros((4, 1, 4)))
    with pytest.raises(ValueError):
        tm.classify_ext(v, base_case=torch.zeros((3, 3, 3), dtype=torch.int64))
    with pytest.raises(ValueError):
        tm.classify_ext(v, base_case=torch.zeros((4, 4, 4), dtype=torch.int32))


# --- conflicted-code tripwire ------------------------------------------------------


def test_count_conflicted_matches_jax():
    vol = np.random.default_rng(3).standard_normal((10, 9, 11))
    ext = _port(vol)
    keep = np.random.default_rng(4).random(ext.shape) < 0.7
    assert tm._conflicted_codes() == jm._conflicted_codes() == ()
    got = tm.count_conflicted(torch.as_tensor(ext), torch.as_tensor(keep))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(jm.count_conflicted(jnp.asarray(ext),
                                               jnp.asarray(keep))) == 0


def test_count_conflicted_recount(monkeypatch):
    """With a patched conflicted-code list the count equals a numpy
    recount under the keep mask."""
    vol = np.random.default_rng(3).standard_normal((10, 9, 11))
    ext = _port(vol)
    keep = np.random.default_rng(4).random(ext.shape) < 0.7
    codes = tuple(int(c) for c in np.unique(ext)[:7])
    monkeypatch.setattr(tm, "_conflicted_codes", lambda: codes)
    want = int((np.isin(ext, codes) & keep).sum())
    assert want > 0
    assert int(tm.count_conflicted(torch.as_tensor(ext),
                                   torch.as_tensor(keep))) == want


def test_load_tables_checks_layout(monkeypatch):
    tm.load_tables.cache_clear()
    monkeypatch.setattr(tb, "OFFSET", tb.OFFSET + 1)
    try:
        with pytest.raises(ValueError, match="layout"):
            tm.load_tables()
    finally:
        tm.load_tables.cache_clear()
    monkeypatch.undo()
    d = tm.load_tables()
    assert d["tri_table"].shape == (5904, 10, 3)
    assert d["tri_table"].dtype == np.int32
