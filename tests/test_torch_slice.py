"""The debug slice: ``sdf_torch.sample_slice``/``show_slice`` against
``sdf_tpu``'s.

Tolerances:
  * ``extent`` and ``axes``: equal.
  * ``a``: bit-equal to EAGER JAX in float64 (jitted XLA contracts the
    example's multiply-adds; the port never does), within 8 eps32 of its
    scale in float32 (the port keeps constants Python floats, which round
    to float32 like weak JAX literals; see tests/test_torch_shapes2.py).
  * the same error, of the same type, when not exactly one of x/y/z is
    given.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
import sdf_torch as sp
from sdf_torch.core import engine as tengine

import torch_helpers as th

BOUNDS = ((-1.2, -1.1, -1.0), (1.2, 1.0, 1.1))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_sample_slice_matches_jax(axis, dtype):
    kw = {axis: 0.0 if axis == "y" else 0.15}
    with jax.disable_jit():
        want = st.sample_slice(th.example(st), 40, 28, bounds=BOUNDS,
                               dtype=getattr(jnp, dtype), **kw)
    got = sp.sample_slice(th.example(sp), 40, 28, bounds=BOUNDS,
                          dtype=getattr(torch, dtype), device="cpu", **kw)
    a, extent, axes = got
    assert a.dtype == np.float64 and a.shape == (40, 28)
    assert extent == want[1] and axes == want[2]
    if dtype == "float64":
        np.testing.assert_array_equal(a, want[0])
    else:
        np.testing.assert_allclose(
            a, want[0], rtol=0,
            atol=8 * np.finfo(np.float32).eps * np.abs(want[0]).max())


def test_default_bounds_and_tensor_contract():
    """bounds=None estimates the bounds as generate() does: the same
    extent as the JAX package's."""
    tengine._BOUNDS_MEMO.clear()
    want = st.sample_slice(th.example(st), 16, 12, z=0.2)
    got = sp.sample_slice(th.example(sp), 16, 12, z=0.2, device="cpu")
    assert got[2] == want[2] == "YX"
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"x": 0.0, "y": 0.1},
                                {"x": 1, "y": 2, "z": 3}])
def test_slice_needs_exactly_one_axis(kw):
    with pytest.raises(Exception, match="x, y, or z position") as want:
        st.sample_slice(th.example(st), 8, 8, bounds=BOUNDS, **kw)
    with pytest.raises(Exception, match="x, y, or z position") as got:
        sp.sample_slice(th.example(sp), 8, 8, bounds=BOUNDS, device="cpu",
                        **kw)
    assert type(got.value) is type(want.value)


def test_show_slice_runs_under_agg(monkeypatch):
    """show_slice plots with matplotlib (imported on the call) under the
    Agg backend; abs=True plots |d|; SDF3.show_slice forwards."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(plt.gcf()))
    sp.show_slice(th.example(sp), 32, 24, z=0.0, bounds=BOUNDS, device="cpu")
    th.example(sp).show_slice(32, 24, x=0.1, bounds=BOUNDS, abs=True,
                              device="cpu")
    assert len(shown) == 2
    img = shown[1].axes[0].images[-1].get_array()
    assert img.shape == (32, 24) and float(np.min(img)) >= 0.0
    assert shown[1].axes[0].get_xlabel() == "Z"
    plt.close("all")


def test_slice_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sp.sample_slice(th.example(sp), 8, 8, z=0.0, bounds=BOUNDS)
