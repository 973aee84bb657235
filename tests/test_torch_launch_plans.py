"""The launch plans of kernels B1 and B4, computed in Python and passed to
the CUDA kernels, checked on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py); here the
plans they are launched with, and numpy mirrors of the kernels' index
rules, are held against the plain versions: every sample of B1's grid is
written by exactly one block and every cell classified exactly once, the
corner bits read from the blocks' ballot words give the case codes, and
B4's chunks read each mask slot once, at any alignment, and put every
index at its rank.  Tolerance: integer outputs, exact.
"""

import re

import numpy as np
import pytest
import torch

import sdf_torch as sp
from sdf_torch import _build
from sdf_torch.core import compact, mc
from sdf_torch.core import eval_classify as ec


def _constant(text, name):
    return int(re.search(r"constexpr int [^;]*\b%s = (\d+)" % name,
                         text).group(1))


def test_plan_constants_match_the_kernel_sources():
    b1 = _build.source("eval_classify.cu")
    assert (_constant(b1, "PZ"), _constant(b1, "PY")) == (ec._PZ, ec._PY)
    assert _constant(b1, "WARPS") * 2 == ec._PY
    b4 = _build.source("compact.cu")
    # _emulate_b4 below runs 256 threads with a granule in each of 4 rows
    assert (_constant(b4, "IDX_THREADS"), _constant(b4, "IDX_ROWS")) == (256, 4)
    assert 256 * 4 * 16 == compact._IDX_CHUNK


def test_wrappers_call_entries_the_sources_define():
    """Every C entry point the wrappers look up is defined in its source."""
    b1 = ec.kernel_source(sp.sphere(1))
    for dt in ("f32", "f64"):
        name = "sdf_eval_classify_" + dt
        assert 'extern "C" int %s(' % name in b1, name
    b4 = _build.source("compact.cu")
    for name in ("sdf_compact_indices", "sdf_compact_count",
                 "sdf_compact_scatter"):
        assert 'extern "C" int %s(' % name in b4, name


# --- B1: the marching slab ---------------------------------------------------


def _axis_blocks(n, cells, samples):
    """Per block along one axis: (first sample, samples it evaluates)."""
    return [(a, min(samples, n - a)) for a in range(0, n - 1, cells)]


def _axis_counts(n, cells, samples):
    """Along one axis, as eval_classify.cu decides: how many blocks write
    each sample (a block's leading ``cells`` samples, and the grid's last
    one in the last block) and classify each cell, and the samples
    evaluated."""
    own = np.zeros(n, np.int64)
    cls = np.zeros(n - 1, np.int64)
    evals = 0
    for a, m in _axis_blocks(n, cells, samples):
        for j in range(m):
            g = a + j
            if j < cells or g == n - 1:
                own[g] += 1
            if j < cells and g < n - 1:
                cls[g] += 1
        evals += m
    return own, cls, evals


SHAPES = [(2, 2, 2), (3, 2, 5), (5, 17, 33), (31, 16, 32), (32, 17, 31),
          (65, 31, 63), (66, 47, 94), (97, 101, 103), (162, 162, 162),
          (256, 256, 256), (407, 407, 407), (129, 1001, 2), (10, 700, 700)]
# Slab lengths: the plan's own, one plane, and lengths that do not divide
# the grids (the card tests force these too).
SLABS = [ec.SLAB, 1, 7, 32, 64]


@pytest.mark.parametrize("lx", SLABS)
@pytest.mark.parametrize("shape", SHAPES)
def test_slab_plan_owns_every_sample_and_cell_once(shape, lx):
    """Each axis of B1's plan: the patch rows along y (15 cells, 16 samples),
    the lanes along z (31 and 32) and the slabs along x (lx and lx + 1)
    cover the grid with every sample owned once and every cell classified
    once; the blocks of the grid are the plan's."""
    nx, ny, nz = shape
    gz, gy, gx = ec.slab_plan(nx, ny, nz, lx)
    evals = 1
    for n, cells, nblocks in ((nx, lx, gx), (ny, ec._PY - 1, gy),
                              (nz, ec._PZ - 1, gz)):
        own, cls, e = _axis_counts(n, cells, cells + 1)
        assert len(_axis_blocks(n, cells, cells + 1)) == nblocks
        assert (own == 1).all() and (cls == 1).all()
        evals *= e
    assert evals == ec.slab_evaluations(nx, ny, nz, lx)
    assert gy <= 65535 and gx <= 65535


@pytest.mark.parametrize("lx", [1, 4, 16, 64])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_slab_lengths_around_multiples(lx, delta):
    """nx = k * lx + 1 + delta (the last slab full, one short, one over),
    and nx shorter than one slab."""
    for nx in (3 * lx + 1 + delta, lx // 2 + 2):
        if nx < 2:
            continue
        own, cls, _ = _axis_counts(nx, lx, lx + 1)
        assert (own == 1).all() and (cls == 1).all()


@pytest.mark.parametrize("shape", [(162,) * 3, (203,) * 3, (256,) * 3,
                                   (323,) * 3, (407,) * 3, (512,) * 3,
                                   (645,) * 3, (300, 150, 100)])
def test_slab_plan_evaluates_each_sample_about_once(shape):
    """Grids of 2^22 (the example) to 2^28 samples, cubes and a box: the
    plan evaluates at most 1.2 times each sample, and at 2^22 it still
    gives the card's 132 SMs several blocks each."""
    assert ec.slab_evaluations(*shape) <= 1.2 * np.prod(shape)
    assert np.prod(ec.slab_plan(*shape)) >= 4 * 132


def _emulate_b1_cases(vol, lx):
    """eval_classify.cu's classification in numpy: each block ballots its
    rows' signs (v < 0) into 32-bit words, plane by plane, and reads each
    cell's eight corner bits from the words of planes x - 1 and x."""
    nx, ny, nz = vol.shape
    inside = np.asarray(vol) < 0
    case = np.full((nx - 1, ny - 1, nz - 1), -1, np.int64)
    cz, cy = ec._PZ - 1, ec._PY - 1
    for z0 in range(0, nz - 1, cz):
        for y0 in range(0, ny - 1, cy):
            for x0 in range(0, nx - 1, lx):
                ring = {}
                for x in range(x0, min(x0 + lx, nx - 1) + 1):
                    words = np.zeros(ec._PY, np.int64)
                    for row in range(ec._PY):
                        for lane in range(ec._PZ):
                            gy, gz = y0 + row, z0 + lane
                            if gy < ny and gz < nz and inside[x, gy, gz]:
                                words[row] |= 1 << lane
                    ring[x] = words
                    if x == x0:
                        continue
                    a, c = ring[x - 1], ring[x]
                    for row in range(cy):
                        for lane in range(cz):
                            gy, gz = y0 + row, z0 + lane
                            if gy >= ny - 1 or gz >= nz - 1:
                                continue
                            code = 0
                            for dz in (0, 1):
                                s = lane + dz
                                bits = [(a[row] >> s) & 1, (c[row] >> s) & 1,
                                        (c[row + 1] >> s) & 1,
                                        (a[row + 1] >> s) & 1]
                                for k, b in enumerate(bits):
                                    code |= int(b) << (4 * dz + k)
                            assert case[x - 1, gy, gz] == -1
                            case[x - 1, gy, gz] = code
    return case


@pytest.mark.parametrize("shape, lx", [((5, 18, 35), 2), ((9, 33, 64), 4),
                                       ((4, 2, 2), 1)])
def test_ballot_words_give_the_case_codes(shape, lx):
    """The corner bits of B1's ring of ballot words are the case codes of
    the plain classification, on a random volume with exact zeros and
    NaNs (neither is inside)."""
    rng = np.random.default_rng(sum(shape))
    vol = rng.standard_normal(shape)
    vol.reshape(-1)[rng.permutation(vol.size)[:vol.size // 10]] = 0.0
    vol.reshape(-1)[rng.permutation(vol.size)[:vol.size // 20]] = np.nan
    want = mc._cell_cases(torch.as_tensor(vol)).numpy()
    np.testing.assert_array_equal(_emulate_b1_cases(vol, lx), want)


# --- B4: one-pass compaction -------------------------------------------------


def _emulate_b4(mask, off, capacity):
    """csrc/compact.cu indices_kernel in numpy, on a mask whose first byte
    sits ``off`` bytes past a 16-byte boundary: the chunks' granules, the
    per-warp and per-block scans in their order, the prefix of the earlier
    chunks, and the scatter; returns (out, count, slots read)."""
    n = len(mask)
    _, nchunks, ntail = compact.indices_plan(off, n, capacity)
    threads, rows = 256, 4
    out = np.full(capacity, -1, np.int64)
    reads = np.zeros(n, np.int64)
    prefix = 0
    for c in range(nchunks):
        v0 = c * compact._IDX_CHUNK
        bits = np.zeros((rows, threads), np.int64)
        for k in range(rows):
            for t in range(threads):
                i = v0 + (k * threads + t) * 16 - off
                lo, hi = max(i, 0), min(i + 16, n)
                if lo < hi:
                    reads[lo:hi] += 1
                    for s in range(lo, hi):
                        if mask[s]:
                            bits[k, t] |= 1 << (s - i)
        cnt = np.vectorize(lambda b: bin(b).count("1"))(bits)
        warp_incl = np.cumsum(cnt.reshape(rows, 8, 32), axis=2)
        sums = warp_incl[:, :, -1].reshape(-1)  # [row][warp]
        warp_excl = (np.cumsum(sums) - sums).reshape(rows, 8)
        for k in range(rows):
            for t in range(threads):
                w, lane = divmod(t, 32)
                r = prefix + warp_excl[k, w] + warp_incl[k, w, lane] \
                    - cnt[k, t]
                i0 = v0 + (k * threads + t) * 16 - off
                m = int(bits[k, t])
                while m and r < capacity:
                    assert out[r] == -1
                    out[r] = i0 + (m & -m).bit_length() - 1
                    m &= m - 1
                    r += 1
        prefix += int(sums.sum())
    # the tail blocks: a grid stride from the count
    for q in range(ntail):
        for t in range(threads):
            for j in range(prefix + q * threads + t, capacity,
                           ntail * threads):
                assert out[j] == -1
                out[j] = 0
    return out, prefix, reads


@pytest.mark.parametrize("off", [0, 1, 7, 15])
@pytest.mark.parametrize("n, density", [(1, 1.0), (37, 0.5), (16383, 0.5),
                                        (16384 + 13, 0.3), (40000, 1e-3),
                                        (2 * 16384, 1.0), (20000, 0.0)])
def test_one_pass_compaction_plan(n, density, off):
    """Every mask slot is read exactly once whatever the alignment, every
    output word is written exactly once, and the output equals the plain
    version; with capacity above and below the count."""
    mask = np.random.default_rng(n + off).random(n) < density
    total = int(mask.sum())
    for cap in (total + 4100, max(1, total // 2), 0):
        got, count, reads = _emulate_b4(mask, off, cap)
        want, wcount = compact._indices_of_plain(torch.as_tensor(mask), cap)
        assert (reads == 1).all()
        np.testing.assert_array_equal(got, want.numpy())
        assert count == int(wcount)


def test_indices_plan_counts():
    assert compact.indices_plan(0, 16384, 0) == (0, 1, 0)
    assert compact.indices_plan(17, 16384, 1) == (1, 2, 1)
    assert compact.indices_plan(32, 2**24 + 13, 2**22) == (0, 1025, 256)
    _, nchunks, ntail = compact.indices_plan(15, 2**31 - 1, 5000)
    assert nchunks == -(-(2**31 + 14) // 16384) and ntail == 2
