"""Dense eval + classify (kernel B1): the port's plain version against the
JAX package's Pallas kernel in interpret mode, on odd-sized grids.

Tolerances:
  * case codes: bit-equal.
  * volumes: |diff| <= 8 eps of the dtype (values and coordinates are of
    order 1, so this is a few ulps of the operands; a near-zero result of
    a cancellation can differ by more ulps of itself).  The Pallas kernel
    traces through XLA, which on
    the CPU contracts multiply-adds into FMAs; the port never contracts (its
    CUDA kernel is built with -fmad=false to equal the plain version), so
    values differ by rounding of the contracted terms.  Against the JAX
    expression evaluated eagerly the port is bit-equal (test_torch_ops.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdf_tpu as st
import sdf_torch as sp
from sdf_tpu.core import pallas_eval
from sdf_tpu.core.node import cast as jcast
from sdf_torch.core import eval_classify as ec
from sdf_torch.core import mc as tmc

import torch_helpers as th

MODELS = {
    "example": th.example,
    "smooth": lambda m: m.sphere(0.6).union(m.box(0.8).translate((0.2, 0, 0)), k=0.2),
    "rounded": lambda m: m.rounded_cylinder(0.5, 0.1, 1.0).orient(m.Y),
}


def _grid():
    # 17 x 19 x 23 samples, not multiples of any block size.
    return (np.linspace(-1.1, 1.1, 17), np.linspace(-1.05, 1.15, 19),
            np.linspace(-1.2, 1.0, 23))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_plain_matches_pallas_interpret(model, dtype):
    X, Y, Z = _grid()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    build = MODELS[model]
    vj, cj = pallas_eval.eval_and_classify(
        jcast(build(st), jd), X, Y, Z, jd, bz=4, interpret=True
    )
    vt, ct = ec.eval_and_classify(build(sp), X, Y, Z, td, "cpu")
    assert vt.shape == (17, 19, 23) and ct.shape == (16, 18, 22)
    assert vt.dtype == td and ct.dtype == torch.int32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    eps = np.finfo(dtype).eps
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=8 * eps)


def test_cell_cases_match_jax():
    """Given the same volume, the case grid is bit-equal."""
    from sdf_tpu.core import mc as jmc

    rng = np.random.default_rng(0)
    vol = rng.normal(size=(9, 10, 11))
    vol[2, 3, 4] = 0.0  # a sample exactly on the level: outside
    np.testing.assert_array_equal(
        tmc._cell_cases(torch.as_tensor(vol)).numpy(),
        np.asarray(jmc._cell_cases(jnp.asarray(vol))),
    )


def test_generated_body_on_grid():
    """The kernel body (numpy-interpreted) over the grid equals the plain
    volume bit for bit, in both dtypes, and the source names both entry
    points."""
    X, Y, Z = _grid()
    f = th.example(sp)
    src = ec.kernel_source(f)
    assert "sdf_eval_classify_f32" in src and "sdf_eval_classify_f64" in src
    for td, nd in ((torch.float32, np.float32), (torch.float64, np.float64)):
        vt, _ = ec.eval_and_classify(f, X, Y, Z, td, "cpu")
        P = ec._flat_params(f, td, "cpu").numpy()
        x, y, z = (a.astype(nd) for a in (X, Y, Z))
        got = th.run_body(src, x[:, None, None], y[None, :, None],
                          z[None, None, :], P)
        np.testing.assert_array_equal(np.broadcast_to(got, vt.shape), vt.numpy())


def test_source_depends_on_structure_not_values():
    """Parameters travel in P: the same structure with other values gives
    the same source (and so reuses the compiled library)."""
    a = ec.kernel_source(sp.sphere(1.0) & sp.box(1.5))
    b = ec.kernel_source(sp.sphere(0.7) & sp.box(1.2))
    c = ec.kernel_source(sp.sphere(1.0) | sp.box(1.5))
    assert a == b
    assert a != c


def test_unsupported_op_names_itself():
    f = sp.sphere(1.0)
    inner = f.fn

    def fn(q, p):
        return torch.erf(inner(q, p))

    g = sp.SDF3(fn, f.params)
    with pytest.raises(NotImplementedError, match="erf"):
        ec.kernel_source(g)


def _point_body(src):
    start = src.index("sdf_point(")
    return src[start: src.index("\n}", start)]


def test_the_three_eval_kernels_share_one_point_body():
    """Kernels B1, B6 and B7 get the same generated ``sdf_point`` and the
    same op helpers, spliced in from csrc/sdf_point.cuh."""
    f = th.example(sp)
    dense, tiles = ec.kernel_source(f), ec.tile_kernel_source(f)
    assert _point_body(dense) == _point_body(tiles)
    assert "//@SDF_BODY@" not in dense + tiles
    for src in (dense, tiles):
        assert src.count("op_min(float a, float b)") == 1
        assert '#include "sdf_point.cuh"' not in src
    assert "eval_classify_kernel" in dense and "eval_tiles_kernel" in tiles
    assert "eval_tiles_kernel" not in dense


def test_cell_cases_take_batch_dims():
    rng = np.random.default_rng(1)
    vols = torch.as_tensor(rng.normal(size=(5, 6, 7, 8)))
    batch = tmc._cell_cases(vols)
    assert batch.shape == (5, 5, 6, 7)
    for i in range(5):
        assert torch.equal(batch[i], tmc._cell_cases(vols[i]))


@pytest.mark.parametrize("wrapper", ["eval_tiles_and_classify_batched",
                                     "eval_tiles_and_classify"])
def test_tile_wrappers_check_their_tile_list(wrapper):
    fn = getattr(ec, wrapper)
    X = np.linspace(-1, 1, 9)
    f = sp.sphere(1)
    for bad in (torch.zeros((2, 3), dtype=torch.int64),
                torch.zeros((2, 2), dtype=torch.int32),
                torch.zeros(6, dtype=torch.int32)):
        with pytest.raises(ValueError, match="tiles"):
            fn(f, X, X, X, bad, 4, torch.float32)
    with pytest.raises(ValueError, match="tile >= 1"):
        fn(f, X, X, X, torch.zeros((2, 3), dtype=torch.int32), 0,
           torch.float32)
    vols, case = fn(f, X, X, X, torch.zeros((0, 3), dtype=torch.int32), 4,
                    torch.float32)
    assert vols.shape == (0, 5, 5, 5) and case.shape == (0, 4, 4, 4)
    assert case.dtype == torch.int32


def _many_spheres(n):
    f = sp.sphere(0.1)
    for i in range(n - 1):
        f = f | sp.sphere(0.05 + 0.001 * i, center=(0.01 * i - 0.5, 0.0, 0.1))
    return f


@pytest.mark.parametrize("nspheres", [1, 96, 97, 100])
def test_parameter_form_follows_the_leaf_count(nspheres):
    """Up to MAX_ARG_PARAMS values travel by value in the kernel arguments
    (the wrapper hands the kernel host values), beyond that in device memory
    (a tensor): chosen when the source is generated, from the leaf count;
    the body reads ``P[k]`` either way and computes the plain volume."""
    f = _many_spheres(nspheres)
    n = ec.param_count(f)
    assert n == 4 * nspheres
    in_args = n <= ec.MAX_ARG_PARAMS
    assert ec.params_in_args(f) == in_args
    for src in (ec.kernel_source(f), ec.tile_kernel_source(f)):
        assert "#define SDF_NPARAMS %d\n" % n in src
        assert "#define SDF_PARAMS_IN_ARGS %d\n" % in_args in src
        assert "//@SDF_PARAMS@" not in src
    P = ec._params_arg(f, torch.float32, "cpu")
    assert isinstance(P, np.ndarray) == in_args
    np.testing.assert_array_equal(np.asarray(P), ec._flat_params(
        f, torch.float32, "cpu").numpy())
    X = np.linspace(-0.7, 0.7, 9)
    vt, _ = ec.eval_and_classify(f, X, X, X, torch.float64, "cpu")
    got = th.run_body(ec.kernel_source(f), X[:, None, None], X[None, :, None],
                      X[None, None, :],
                      ec._flat_params(f, torch.float64, "cpu").numpy())
    np.testing.assert_array_equal(np.broadcast_to(got, vt.shape), vt.numpy())
