"""The dense generate() end to end, sdf_torch (device="cpu", the kernels'
plain versions) against sdf_tpu on JAX-CPU.

The JAX reference runs on a 1-device mesh (tests/conftest.py gives JAX
eight virtual devices, and with more than one generate() shards).

Tolerances:
  * bounds: float64 bit-equal; float32 equal (the float64 loop state and
    the 1e-4 slack make the refinement machine-independent).
  * skip mask, case grid, faces, triangle counts: equal.
  * float64 vertices: |diff| <= 1e-14 and the canonical soup sha256 (9
    decimals) equal.  Not bit-equal: jitted XLA on the CPU contracts the
    expression's multiply-adds into FMAs and the port does not (its CUDA
    kernel must equal its plain version), so volumes differ by an ulp or
    so and interpolated positions by a few ulps.
  * float32: the triangle count equal, vertices within 2e-6.
"""

import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
import sdf_torch as sp
from sdf_tpu.core import engine as jengine
from sdf_tpu.io import stl as jstl
from sdf_tpu.parallel import grid as pgrid
from sdf_torch.core import engine as tengine

import torch_helpers as th

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "example_topology.npz")


def _jax_generate(f, **kw):
    return f.generate(
        verbose=False, mc_variant="fast", mesh=pgrid.make_mesh(jax.devices()[:1]),
        **kw,
    )


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bounds_equal(dtype):
    lo_j, hi_j, e_j = jengine._estimate_bounds_host(
        th.example(st), getattr(jnp, dtype)
    )
    lo_t, hi_t, e_t = tengine._estimate_bounds_host(
        th.example(sp), getattr(torch, dtype)
    )
    assert e_j == e_t
    np.testing.assert_array_equal(lo_t, lo_j)
    np.testing.assert_array_equal(hi_t, hi_j)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_skip_mask_equal(dtype):
    X = np.arange(-0.95, 0.95, 0.045)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jengine._skip_mask(
        jengine.cast(th.example(st), jd), X, X, X, 8, jd
    )
    assert want.any() and not want.all()
    got = tengine._skip_mask(th.example(sp), X, X, X, 8, td)
    np.testing.assert_array_equal(got, want)
    dev, tshape = tengine._skip_mask_device(th.example(sp), X, X, X, 8, td, "cpu")
    np.testing.assert_array_equal(dev.reshape(tshape).numpy(), want)


def test_generate_f64_matches_jax():
    want = _jax_generate(th.example(st), samples=2**15, dtype=jnp.float64)
    got = sp.generate(th.example(sp), samples=2**15, verbose=False,
                      dtype=torch.float64, mc_variant="fast", device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    assert th.soup_hash(got) == th.soup_hash(want)


def test_generate_f32_matches_jax():
    want = _jax_generate(th.example(st), samples=2**15, dtype=jnp.float32)
    got = th.example(sp).generate(samples=2**15, verbose=False,
                                  mc_variant="fast", device="cpu")
    assert len(got) // 3 == len(want) // 3
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_generate_mesh_matches_jax():
    vw, fw = _jax_generate(th.example(st), samples=2**14, dtype=jnp.float64,
                           output="mesh")
    vg, fg = th.example(sp).generate_mesh(samples=2**14, verbose=False,
                                          dtype=torch.float64,
                                          mc_variant="fast", device="cpu")
    assert fg.dtype == np.int32 and vg.dtype == np.float64
    np.testing.assert_array_equal(fg, fw)
    np.testing.assert_allclose(vg, vw, rtol=0, atol=1e-14)
    # the soup is the mesh's faces gathered
    pts = sp.generate(th.example(sp), samples=2**14, verbose=False,
                      dtype=torch.float64, mc_variant="fast", device="cpu")
    np.testing.assert_array_equal(pts, vg[fg.reshape(-1)])


def test_debug_boxes_match_jax():
    kw = dict(samples=2**12, dtype=jnp.float64, debug=True, batch_size=4)
    want = _jax_generate(th.example(st), **kw)
    kw["dtype"] = torch.float64
    got = sp.generate(th.example(sp), verbose=False, mc_variant="fast",
                      device="cpu", **kw)
    assert len(got) == len(want)
    assert th.soup_hash(got) == th.soup_hash(want)


def test_stl_round_trip(tmp_path):
    path = str(tmp_path / "out.stl")
    pts = th.example(sp).save(path, samples=2**13, verbose=False,
                              mc_variant="fast", device="cpu")
    verts, tris = sp.stl.read_binary_stl(path)
    assert len(tris) == len(pts) // 3
    jverts, jtris = jstl.read_binary_stl(path)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(tris, jtris)
    np.testing.assert_array_equal(
        verts[tris.reshape(-1)], pts.astype(np.float32).astype(np.float64)
    )


def test_golden_example_topology():
    """tests/golden/example_topology.npz (step 0.04, float64, sparse=False,
    fast): the case grid, triangle count and canonical soup hash."""
    from sdf_torch.core import eval_classify

    f = th.example(sp)
    pts = f.generate(step=0.04, bounds=((-1.1,) * 3, (1.1,) * 3), verbose=False,
                     dtype=torch.float64, sparse=False, mc_variant="fast",
                     device="cpu")
    X = np.arange(-1.1, 1.1, 0.04)
    _, case = eval_classify.eval_and_classify(f, X, X, X, torch.float64, "cpu")
    with np.load(GOLDEN) as z:
        np.testing.assert_array_equal(case.numpy().astype(np.uint8), z["case"])
        assert len(pts) // 3 == int(z["n_triangles"])
        assert th.soup_hash(pts) == str(z["soup_sha256"])


def test_verbose_format_and_stats():
    buf_j, buf_t = io.StringIO(), io.StringIO()
    with redirect_stdout(buf_j):
        th.example(st).generate(samples=2**12, dtype=jnp.float64,
                                mc_variant="fast",
                                mesh=pgrid.make_mesh(jax.devices()[:1]))
    with redirect_stdout(buf_t):
        th.example(sp).generate(samples=2**12, dtype=torch.float64,
                                mc_variant="fast", device="cpu")

    def lines(buf):
        out = [l.split("\r")[-1].strip() for l in buf.getvalue().splitlines()]
        return [l for l in out if l and not l.startswith(("%", "0%", "100%"))]

    lj, lt = lines(buf_j), lines(buf_t)
    assert lt[:3] == lj[:3]  # min / max / step
    assert lt[3].split(" with ")[0] == lj[3].split(" with ")[0]
    assert lt[3].endswith("with 1 devices")
    assert lt[-2] == lj[-2]  # skipped / empty / nonempty
    assert lt[-1].split(" in ")[0] == lj[-1].split(" in ")[0]
    for key in ("bounds", "skip_dispatch", "eval_classify", "mc_count",
                "mc_emit", "d2h", "decode", "batches", "samples", "skipped",
                "empty", "nonempty", "triangles", "total"):
        assert key in tengine.LAST_STATS


@pytest.mark.parametrize(
    "kw,item",
    [
        ({}, "A5"),  # mc_variant="lewiner", the default
        ({"mc_variant": "fast", "sparse": "tiles"}, "A11"),
        ({"mc_variant": "fast", "mesh": object()}, "A14"),
        ({"mc_variant": "fast", "checkpoint": "run.ckpt"}, "A8"),
    ],
)
def test_unported_branches_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        th.example(sp).generate(samples=2**12, verbose=False, device="cpu", **kw)


def test_cull_routing_to_tiles_raises():
    f = sp.sphere(0.1)
    with pytest.raises(NotImplementedError, match="A11"):
        f.generate(bounds=((-1,) * 3, (1,) * 3), samples=2**15, batch_size=4,
                   verbose=False, mc_variant="fast", device="cpu")


def test_non_stl_save_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="A8"):
        th.example(sp).save(str(tmp_path / "out.obj"), samples=2**12,
                            verbose=False, mc_variant="fast", device="cpu")
