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
  * lewiner (the default variant): the same tolerances; its ext codes are
    held bit-equal to eager JAX in tests/test_torch_mc33.py.
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
from sdf_torch.core import node as tnode
from sdf_torch.utils import checkpoint as tckpt

import torch_helpers as th

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "example_topology.npz")
GOLDEN_LEWINER = os.path.join(os.path.dirname(__file__), "golden",
                              "example_topology_lewiner.npz")


def _jax_generate(f, mc_variant="fast", **kw):
    return f.generate(
        verbose=False, mc_variant=mc_variant,
        mesh=pgrid.make_mesh(jax.devices()[:1]), **kw,
    )


@pytest.fixture(autouse=True)
def _fresh_memos():
    """Each test starts with the engine's memos empty."""
    tengine._BOUNDS_MEMO.clear()
    tengine._COUNTS_MEMO.clear()
    tengine._SKIP_MEMO.clear()


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


class _Ranks:
    """A stand-in for a 1-D DeviceMesh of ``n`` ranks, seen from rank 0."""

    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n

    def get_local_rank(self, axis=None):
        return 0


@pytest.mark.parametrize("variant", ["lewiner", "fast"])
@pytest.mark.parametrize(
    "kw,item",
    [({"sparse": "tiles", "mesh": _Ranks(2)}, "checkpoint"),
     ({"mesh": _Ranks(2)}, "checkpoint")],
    ids=["tiles", "mesh"],
)
def test_unported_branches_raise(kw, item, variant, tmp_path):
    """Every ``mesh=`` branch is ported (the test keeps the name it had
    while they raised; tests/test_torch_parallel.py runs them on ranks):
    what raises under a mesh of more than one rank is ``checkpoint=``,
    since each rank holds only its share.  A mesh of one rank is the
    single-device run, bit for bit."""
    call = dict(samples=2**12, verbose=False, device="cpu", mc_variant=variant)
    with pytest.raises(ValueError, match=item):
        th.example(sp).generate(checkpoint=str(tmp_path / "c.npz"), **kw,
                                **call)
    one = dict(kw, mesh=_Ranks(1))
    assert np.array_equal(th.example(sp).generate(**one, **call),
                          th.example(sp).generate(sparse=kw.get("sparse", True),
                                                  **call))


def test_cull_routing_to_tiles_raises():
    """A cull that routes to the tiles raises nothing any more (the test
    keeps the name it had while that branch was not ported): the run takes
    the tiled path and meshes what sparse=False meshes."""
    f = sp.sphere(0.1)
    kw = dict(bounds=((-1,) * 3, (1,) * 3), samples=2**15, batch_size=4,
              verbose=False, mc_variant="fast", device="cpu")
    got = f.generate(**kw)
    assert tengine.LAST_STATS["auto_tiles"] >= tengine.AUTO_TILES_THRESHOLD
    assert "sparse_tiles" in tengine.LAST_STATS
    assert "mc33_conflicted_cells" not in tengine.LAST_STATS
    want = f.generate(sparse=False, **kw)
    assert len(got) and th.soup_hash(got) == th.soup_hash(want)


@pytest.mark.parametrize("sparse", [None, "dense", 1.5, "Tiles"])
def test_sparse_takes_true_false_or_tiles(sparse):
    with pytest.raises(ValueError, match="sparse"):
        th.example(sp).generate(samples=2**10, verbose=False, device="cpu",
                                sparse=sparse)


def test_routed_lewiner_run_keeps_the_dense_conflict_count():
    """As in the JAX package: a routed sparse=True run has counted the
    conflicted cells in its dense pass; sparse='tiles' leaves the key out."""
    kw = dict(bounds=((-1,) * 3, (1,) * 3), samples=2**15, batch_size=4,
              verbose=False, device="cpu")
    sp.sphere(0.1).generate(**kw)
    assert "auto_tiles" in tengine.LAST_STATS
    assert tengine.LAST_STATS["mc33_conflicted_cells"] == 0
    sp.sphere(0.1).generate(sparse="tiles", **kw)
    assert "auto_tiles" not in tengine.LAST_STATS
    assert "mc33_conflicted_cells" not in tengine.LAST_STATS


def test_non_stl_save_raises(tmp_path):
    """An extension that no writer serves raises; OBJ and PLY are written
    (tests/test_torch_io.py reads them back)."""
    with pytest.raises(ValueError, match="unsupported"):
        th.example(sp).save(str(tmp_path / "out.xyz"), samples=2**12,
                            verbose=False, mc_variant="fast", device="cpu")


@pytest.mark.parametrize("ext", [".obj", ".ply"])
def test_non_stl_save_round_trip(tmp_path, ext):
    path = str(tmp_path / ("out" + ext))
    pts = th.example(sp).save(path, samples=2**12, verbose=False,
                              dtype=torch.float64, device="cpu")
    verts, tris = sp.io.meshfmt.read_mesh(path)
    assert len(tris) == len(pts) // 3
    np.testing.assert_allclose(verts[tris.reshape(-1)], pts, rtol=0, atol=1e-6)


# --- the default variant (lewiner) ---------------------------------------------


def test_default_generate_f64_matches_jax():
    """generate() at its defaults (no mc_variant): triangle count and
    canonical soup equal to sdf_tpu's default run."""
    want = _jax_generate(th.example(st), mc_variant="lewiner", samples=2**15,
                         dtype=jnp.float64)
    got = sp.generate(th.example(sp), samples=2**15, verbose=False,
                      dtype=torch.float64, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    assert th.soup_hash(got) == th.soup_hash(want)
    assert tengine.LAST_STATS["mc33_conflicted_cells"] == 0


def test_default_generate_f32_face_branch_1_packed():
    """A float32 grid past 2^18 cells: with 13 case bits the packed cell
    word no longer holds the cell index, so face resolution takes branch 1
    while the emit stays packed.  Against the JAX run: count equal, vertices
    within the float32 tolerance."""
    from sdf_torch.core import mc as tmc

    bounds = ((-1.1,) * 3, (1.1,) * 3)
    kw = dict(step=2.2 / 66, bounds=bounds)
    ncells = 66 ** 3
    bits = tmc.get_tables("lewiner").case_bits
    assert bits == 13 and tmc._face_branch(ncells, bits) == 1
    assert tmc._face_branch(ncells, tmc.get_tables("fast").case_bits) == 0
    want = _jax_generate(th.example(st), mc_variant="lewiner",
                         dtype=jnp.float32, **kw)
    got = th.example(sp).generate(verbose=False, device="cpu", **kw)
    assert len(got) // 3 == len(want) // 3 > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    # the same soup through the unpacked float64 emit of the float32 volume's
    # faces: the mesh form agrees with the soup
    v, f = th.example(sp).generate_mesh(verbose=False, device="cpu", **kw)
    np.testing.assert_array_equal(v[f.reshape(-1)], got)


def test_golden_example_topology_lewiner():
    """tests/golden/example_topology_lewiner.npz (step 0.04, float64,
    sparse=False): the extended case grid, triangle count and soup hash."""
    from sdf_torch.core import eval_classify, mc33

    f = th.example(sp)
    pts = f.generate(step=0.04, bounds=((-1.1,) * 3, (1.1,) * 3), verbose=False,
                     dtype=torch.float64, sparse=False, mc_variant="lewiner",
                     device="cpu")
    X = np.arange(-1.1, 1.1, 0.04)
    vol, case = eval_classify.eval_and_classify(f, X, X, X, torch.float64, "cpu")
    ext = mc33.classify_ext(vol, base_case=case)
    with np.load(GOLDEN_LEWINER) as z:
        np.testing.assert_array_equal(ext.numpy(), z["ext"])
        assert len(pts) // 3 == int(z["n_triangles"])
        assert th.soup_hash(pts) == str(z["soup_sha256"])


def test_conflicted_cells_stat_only_under_lewiner():
    kw = dict(samples=2**12, verbose=False, device="cpu")
    th.example(sp).generate(**kw)
    assert tengine.LAST_STATS["mc33_conflicted_cells"] == 0
    assert "classify_ext" in tengine.LAST_STATS
    th.example(sp).generate(mc_variant="fast", **kw)
    assert "mc33_conflicted_cells" not in tengine.LAST_STATS
    assert "classify_ext" not in tengine.LAST_STATS


def test_conflicted_cells_are_counted_and_printed(monkeypatch):
    """With a patched conflicted-code list the count lands in LAST_STATS
    and in the verbose report, as in the JAX package."""
    from sdf_torch.core import mc33

    kw = dict(samples=2**12, dtype=torch.float64, device="cpu")
    f = th.example(sp)
    monkeypatch.setattr(mc33, "_conflicted_codes", lambda: (0, 5895))
    buf = io.StringIO()
    with redirect_stdout(buf):
        f.generate(**kw)
    n = tengine.LAST_STATS["mc33_conflicted_cells"]
    assert n > 0
    assert "%d cells hit majority-voted MC33 table entries" % n in buf.getvalue()


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="mc_variant"):
        th.example(sp).generate(samples=2**12, verbose=False, device="cpu",
                                mc_variant="nope")


# --- memos ------------------------------------------------------------------------


def _count_calls(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_second_call_probes_nothing(monkeypatch, dtype):
    """The bounds and counts memos: a repeat call on an unchanged (rebuilt)
    model probes no bounds, fetches once instead of twice, and returns a
    bit-equal soup with the same statistics."""
    probes = _count_calls(monkeypatch, tengine, "_estimate_bounds_host")
    fetches = _count_calls(monkeypatch, tnode, "fetch")
    kw = dict(samples=2**13, verbose=False, dtype=dtype, device="cpu")
    first = th.example(sp).generate(**kw)
    stats = dict(tengine.LAST_STATS)
    assert (len(probes), len(fetches)) == (1, 2)
    second = th.example(sp).generate(**kw)
    assert (len(probes), len(fetches)) == (1, 3)
    np.testing.assert_array_equal(second, first)
    for key in ("batches", "samples", "skipped", "empty", "nonempty",
                "triangles", "mc33_conflicted_cells"):
        assert tengine.LAST_STATS[key] == stats[key]


def test_memos_miss_on_any_change(monkeypatch):
    probes = _count_calls(monkeypatch, tengine, "_estimate_bounds_host")
    fetches = _count_calls(monkeypatch, tnode, "fetch")
    kw = dict(samples=2**12, verbose=False, device="cpu")
    f = lambda r=1.0, k=None: sp.sphere(r) & sp.box(1.5).k(k)
    f().generate(**kw)
    assert (len(probes), len(fetches)) == (1, 2)
    f(k=0.1).generate(**kw)          # a .k() tag misses both memos
    assert (len(probes), len(fetches)) == (2, 4)
    f(r=1.01).generate(**kw)         # a parameter edit misses both
    assert (len(probes), len(fetches)) == (3, 6)
    f().generate(mc_variant="fast", **kw)   # bounds hit, counts miss
    assert (len(probes), len(fetches)) == (3, 8)
    f().generate(sparse=False, **kw)        # another cull mode: counts miss
    assert (len(probes), len(fetches)) == (3, 10)
    f().generate(**{**kw, "samples": 2**11})  # another grid: counts miss
    assert (len(probes), len(fetches)) == (3, 12)
    f().generate(dtype=torch.float64, **kw)  # another dtype misses both
    assert (len(probes), len(fetches)) == (4, 14)
    f().generate(**kw)               # the first call again: both hit
    assert (len(probes), len(fetches)) == (4, 15)


def test_memoized_empty_mesh():
    """A model with no surface inside the given bounds, twice."""
    kw = dict(bounds=((2, 2, 2), (3, 3, 3)), samples=2**9, verbose=False,
              sparse=False, device="cpu")
    for _ in range(2):
        pts = sp.sphere(1).generate(**kw)
        assert pts.shape == (0, 3)
        assert tengine.LAST_STATS["triangles"] == 0
        assert tengine.LAST_STATS["nonempty"] == 0


def test_memos_are_bounded():
    for i in range(tckpt.MEMO_MAX + 5):
        tckpt.memo_put(tengine._BOUNDS_MEMO, ("k", i), i)
    assert len(tengine._BOUNDS_MEMO) <= tckpt.MEMO_MAX + 1
    tckpt.memo_put(tengine._BOUNDS_MEMO, None, 1)
    assert None not in tengine._BOUNDS_MEMO


def test_fetch_is_one_transfer_of_mixed_dtypes():
    ts = [torch.arange(5, dtype=torch.int32), torch.tensor(3.5),
          torch.tensor([[True, False, True]]),
          torch.arange(6, dtype=torch.float64).reshape(2, 3)[:, :2],
          torch.zeros((0, 3), dtype=torch.int64)]
    out = tnode.fetch(ts)
    for t, a in zip(ts, out):
        assert a.shape == tuple(t.shape)
        np.testing.assert_array_equal(a, t.numpy())
        assert a.dtype == t.numpy().dtype


# --- checkpoint= --------------------------------------------------------------------


def test_checkpoint_round_trip(tmp_path, monkeypatch):
    path = str(tmp_path / "run.ckpt")
    kw = dict(samples=2**12, verbose=False, device="cpu", checkpoint=path)
    first = th.example(sp).generate(**kw)
    assert os.path.exists(path)
    evals = _count_calls(monkeypatch, tengine.eval_classify,
                         "eval_and_classify")
    buf = io.StringIO()
    with redirect_stdout(buf):
        again = th.example(sp).generate(**{**kw, "verbose": True})
    assert len(evals) == 0
    np.testing.assert_array_equal(again, first)
    assert "resumed %d triangles from %s" % (len(first) // 3, path) in (
        buf.getvalue())
    # another configuration recomputes and overwrites the file
    other = th.example(sp).generate(**{**kw, "mc_variant": "fast"})
    assert len(evals) == 1
    np.testing.assert_array_equal(
        sp.utils.checkpoint.merge([path]), other)
    sp.sphere(0.5).generate(**kw)
    assert len(evals) == 2


def test_checkpoint_with_mesh_output_raises(tmp_path):
    with pytest.raises(ValueError, match="checkpoint"):
        th.example(sp).generate_mesh(samples=2**12, verbose=False,
                                     device="cpu",
                                     checkpoint=str(tmp_path / "run.ckpt"))
