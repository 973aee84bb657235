"""The port's lewiner table builder (sdf_torch.core.mc33_build) against the
JAX package's (sdf_tpu.core.mc33_build, pure numpy and scipy), on the CPU.

Inputs are numpy draws from fixed seeds, handed to both.  Tolerance: exact
everywhere -- loops, coefficients, keys, labels, partitions, triangles and
every built array (dtype, shape and values), since the port performs the
reference's IEEE operations in the reference's order and draws the same
numpy random stream.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from sdf_tpu.core import mc33_build as jb
from sdf_torch.core import mc33 as tm33
from sdf_torch.core import mc33_build as tb

from test_torch_mc33 import _DEGENERATE_CELLS, _TIE_CELL, _TIE_SCALES

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The builder runs thousands of small torch ops; beside other test
    processes, torch's intra-op threads then wait on each other more than
    they work (the same build took ten times as long), so this module runs
    them on one thread.  Results do not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
KEY_CASES = [5, 60, 90, 105, 165, 23]
# Cases with ambiguous faces, several loops or a tunnel slot: where the
# oracle decides something.
ORACLE_CASES = [5, 24, 60, 90, 105, 129, 165, 195]


@pytest.mark.parametrize("first", range(0, 256, 32))
def test_loops_of_equal(first):
    for case in range(first, first + 32):
        assert tb.ambiguous_faces(case) == jb.ambiguous_faces(case)
        for fb in range(1 << len(jb.ambiguous_faces(case))):
            assert tb.loops_of(case, fb) == jb.loops_of(case, fb), (case, fb)


def test_trilinear_coeffs_and_eval_equal():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(10_000, 8))
    k = tb.trilinear_coeffs(v)
    np.testing.assert_array_equal(k, jb.trilinear_coeffs(v))
    x, y, z = rng.uniform(size=(3, 10_000))
    np.testing.assert_array_equal(tb.trilinear_eval(k, x, y, z),
                                  jb.trilinear_eval(k, x, y, z))
    np.testing.assert_array_equal(tb._C, jb._C)


def _same(got, want):
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", KEY_CASES)
def test_bucket_keys_bit_equal(case):
    """10^5 realizations of a case: the joined bits, interior codes,
    extended codes and packed facebits on torch (CPU) equal numpy's."""
    v = jb.sample_realizations(case, 100_000, np.random.default_rng(case))
    _same(tb.face_joined_bits(v, device="cpu"), jb.face_joined_bits(v))
    _same(tb.interior_bits(v, device="cpu"), jb.interior_bits(v))
    _same(tb.ext_code(v, device="cpu"), jb.ext_code(v))
    _same(tb.ext_code(v, np.full(len(v), case), device="cpu"),
          jb.ext_code(v, np.full(len(v), case)))
    _same(tb._facebits_of(v, case, device="cpu"), jb._facebits_of(v, case))


def test_bucket_keys_on_degenerate_and_tie_cells():
    cells = _DEGENERATE_CELLS + [[x * s for x in _TIE_CELL]
                                 for s in _TIE_SCALES]
    v = np.asarray(cells, np.float64)
    _same(tb.interior_bits(v, device="cpu"), jb.interior_bits(v))
    _same(tb.face_joined_bits(v, device="cpu"), jb.face_joined_bits(v))
    _same(tb.ext_code(v, device="cpu"), jb.ext_code(v))
    # a tensor keeps its device
    _same(tb.ext_code(torch.from_numpy(v)), jb.ext_code(v))


def _scipy_partition_equal(labels, mask):
    """``labels`` (n^3,) canonical labels of both classes of ``mask``:
    the same partition as scipy's two labellings, each label the smallest
    flat index of its component."""
    lab_in, _ = ndimage.label(mask)
    lab_out, _ = ndimage.label(~mask)
    ref = np.where(mask, lab_in, -lab_out).reshape(-1)
    # canonical: each component's label is its smallest member, the first
    # occurrence of its scipy label
    _, first, inverse = np.unique(ref, return_index=True, return_inverse=True)
    np.testing.assert_array_equal(labels, first[inverse])


@pytest.mark.parametrize("n", [2, 8, 16, 32, 64])
def test_plain_labels_match_scipy_on_random_masks(n):
    rng = np.random.default_rng(n)
    masks = rng.uniform(size=(3, n, n, n)) < np.array([0.3, 0.5, 0.7])[
        :, None, None, None]
    labels = tb._label_volume_plain(torch.from_numpy(masks)).numpy()
    for mask, lab in zip(masks, labels):
        _scipy_partition_equal(lab, mask)


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_plain_labels_match_scipy_on_trilinear_masks(n):
    rng = np.random.default_rng(100 + n)
    v = np.concatenate([jb.sample_realizations(c, 2, rng)
                        for c in ORACLE_CASES])
    k = tb.trilinear_coeffs(v)
    t = np.linspace(0.0, 1.0, n)
    x, y, z = np.meshgrid(t, t, t, indexing="ij")
    cls = tb._sample_classes(torch.from_numpy(k), torch.from_numpy(t))
    labels = tb._label_volume_plain(cls).numpy()
    cls_c, lab_c = tb.label_corners(torch.from_numpy(k), torch.from_numpy(t))
    at = tb._corner_index(n)
    for b in range(len(v)):
        mask = jb.trilinear_eval(k[b], x, y, z) < 0
        np.testing.assert_array_equal(cls[b].numpy(), mask)
        _scipy_partition_equal(labels[b], mask)
        np.testing.assert_array_equal(cls_c[b].numpy(), mask.reshape(-1)[at])
        np.testing.assert_array_equal(lab_c[b].numpy(), labels[b][at])
    assert cls_c.dtype == torch.uint8 and lab_c.dtype == torch.int32


def _reference_outcome(v, loops, n):
    try:
        return jb.loop_partition(v, loops, n=n)
    except AssertionError:
        return "assert"


def _port_outcome(v, loops, n):
    try:
        return tb.loop_partition(v, loops, n=n, device="cpu")
    except AssertionError as e:
        assert "touches multiple 3D components" in str(e)
        assert "n=%d" % n in str(e)
        return "assert"


@pytest.mark.parametrize("n, per_case", [(8, 40), (16, 25), (32, 10),
                                         (64, 3)])
def test_loop_partition_equal(n, per_case):
    rng = np.random.default_rng(7 * n)
    asserts = 0
    for case in ORACLE_CASES:
        v = jb.sample_realizations(case, per_case, rng)
        fbs = jb._facebits_of(v, case)
        for vi, fb in zip(v, fbs):
            loops = jb.loops_of(case, int(fb))
            want = _reference_outcome(vi, loops, n)
            assert _port_outcome(vi, loops, n) == want, (case, n)
            asserts += want == "assert"
    if n == 8:
        assert asserts > 0  # the coarse grid trips the check somewhere


@pytest.mark.parametrize("n0", [8, 16])
def test_partition_escalating_equal(n0):
    """One at a time and in one batch, against the reference, on
    realizations of which some trip the check at n0 and escalate."""
    rng = np.random.default_rng(n0)
    escalated = 0
    for case in ORACLE_CASES:
        v = jb.sample_realizations(case, 12, rng)
        fb = int(jb._facebits_of(v[:1], case)[0])
        same = v[jb._facebits_of(v, case) == fb]
        loops = jb.loops_of(case, fb)
        want = [jb._partition_escalating(vi, loops, n0) for vi in same]
        assert tb._partitions_escalating(same, loops, n0, CPU) == want
        for vi, w in zip(same[:3], want):
            assert tb._partition_escalating(vi, loops, n0, "cpu") == w
            escalated += _reference_outcome(vi, loops, n0) == "assert"
    if n0 == 8:
        assert escalated > 0


def test_triangulate_component_equal():
    """Every (case, facebits) with two or more loops, all loops as one
    component, on a realization's crossing positions; and the singletons."""
    rng = np.random.default_rng(5)
    checked = 0
    for case in range(1, 255):
        vrep = jb.sample_realizations(case, 1, rng)[0]
        pos = jb._edge_midpoints(vrep)
        np.testing.assert_array_equal(tb._edge_midpoints(vrep), pos)
        for fb in range(1 << len(jb.ambiguous_faces(case))):
            loops = jb.loops_of(case, fb)
            for group in ([loops[:1]] + ([loops] if len(loops) > 1 else [])):
                assert (tb.triangulate_component(group, pos)
                        == jb.triangulate_component(group, pos))
                checked += len(group) > 1
    assert checked > 0


def test_sample_realizations_draw_numpys_stream():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for case in (1, 90, 254):
        np.testing.assert_array_equal(tb.sample_realizations(case, 500, a),
                                      jb.sample_realizations(case, 500, b))
        np.testing.assert_array_equal(tb._default_realization(case),
                                      jb._default_realization(case))


@pytest.fixture(scope="module")
def builds():
    """The reference's and the port's tables at the two small settings:
    (600, 3, 8) escalates to n=256 and leaves 11 conflicted buckets,
    (2000, 1, 32) is the plain path."""
    out = {}
    for args in ((600, 3, 8), (2000, 1, 32)):
        out[args] = (jb.build_tables(*args, seed=7),
                     tb.build_tables(*args, seed=7, device="cpu"))
    return out


@pytest.mark.parametrize("args", [(600, 3, 8), (2000, 1, 32)])
@pytest.mark.parametrize("key", ["tri_table", "ntri", "offset", "weight",
                                 "realizable", "ncomp", "conflict_rate"])
def test_build_tables_equal(builds, args, key):
    want, got = builds[args]
    assert sorted(got) == sorted(want)
    assert got[key].dtype == want[key].dtype
    assert got[key].shape == want[key].shape
    np.testing.assert_array_equal(got[key], want[key])
    if key == "conflict_rate" and args == (600, 3, 8):
        assert int((got[key] > 0).sum()) == 11


def _partition_from_tris(loops, tris):
    """Loop partition implied by a triangulation: loops whose edges are
    connected through shared triangle vertices."""
    parent = list(range(12))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b, c in tris:
        parent[find(a)] = find(b)
        parent[find(b)] = find(c)
    groups = {}
    for li, loop in enumerate(loops):
        groups.setdefault(find(loop[0]), []).append(li)
    return tuple(sorted(tuple(sorted(g)) for g in groups.values()))


def test_sampled_entries_match_trilinear_oracle():
    """The port's counterpart of test_lewiner.py's test of the same name, on
    the port's own oracle (the plain labeller) against the port's shipped
    table: for a deterministic sample of realizable, unconflicted codes, the
    table entry's loop partition equals the oracle's on a fresh
    realization."""
    d = tm33.load_tables()
    realizable = np.flatnonzero(d["realizable"] & (d["conflict_rate"] == 0))
    rng = np.random.default_rng(23)
    chosen = rng.choice(realizable, size=60, replace=False)
    by_case = {}
    for e in chosen:
        case = int(np.searchsorted(tb.OFFSET, e, "right") - 1)
        by_case.setdefault(case, []).append(int(e))
    checked = 0
    for case, exts in by_case.items():
        v = tb.sample_realizations(case, 40000, rng)
        codes = tb.ext_code(v, np.full(len(v), case), device="cpu").numpy()
        for e in exts:
            idx = np.flatnonzero(codes == e)
            if not len(idx):
                continue  # rare code not re-hit in this draw
            fb = (e - tb.OFFSET[case]) // 9
            loops = tb.loops_of(case, fb)
            part = tb._partition_escalating(v[idx[0]], loops, 64, "cpu")
            if part is None:
                continue  # adversarially thin sample
            tris = d["tri_table"][e][: d["ntri"][e]]
            assert _partition_from_tris(loops, tris) == part, (case, fb, e)
            checked += 1
    assert checked >= 40


def test_builder_and_oracle_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = jb.sample_realizations(90, 1, np.random.default_rng(0))[0]
    loops = jb.loops_of(90, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.build_tables(100, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.loop_partition(v, loops)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb._partition_escalating(v, loops, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.interior_bits(v[None])


def test_label_corners_checks_its_inputs():
    k = torch.zeros((2, 8), dtype=torch.float64)
    t = torch.from_numpy(np.linspace(0.0, 1.0, 4))
    with pytest.raises(ValueError):
        tb.label_corners(k.float(), t)
    with pytest.raises(ValueError):
        tb.label_corners(k[:, :7], t)
    with pytest.raises(ValueError):
        tb.label_corners(k, t[:1])
    meta = torch.zeros((2, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        tb.label_corners(meta, t.to("meta"))
    before = tb.label_corners.launches
    cls, lab = tb.label_corners(k, t)  # all f = 0: one outside component
    assert tb.label_corners.launches == before
    assert cls.tolist() == [[0] * 8] * 2 and lab.tolist() == [[0] * 8] * 2
