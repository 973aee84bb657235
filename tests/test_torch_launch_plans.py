"""The launch plans of kernels B1, B2, B3, B4 and B6/B7, computed in Python
and passed to the CUDA kernels, checked on the CPU.

The kernels run only on the card (tests/test_torch_cuda.py); here the
plans they are launched with, and numpy mirrors of the kernels' index
rules, are held against the plain versions: every sample of B1's grid is
written by exactly one block and every cell classified exactly once, the
corner bits read from the blocks' ballot words give the case codes; B2's
row blocks classify every cell once from corners loaded at
CORNER_OFFSETS' samples; B3's head, vectors and tail cover every code
once at any int32 offset; B4's chunks read each mask slot once, at any
alignment, and put every index at its rank; and B6/B7's blocks write
every sample of a tile row once and classify every cell once from the
ballot words of its sign bits and the halo of the next block of its
cluster.  Tolerance: integer
outputs, exact.
"""

import re

import numpy as np
import pytest
import torch

import sdf_torch as sp
from sdf_torch import _build
from sdf_torch.core import compact, mc, mc33
from sdf_torch.core import eval_classify as ec
from sdf_torch.core.mc_tables import CORNER_OFFSETS


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
    b2 = _build.source("classify_ext.cu")
    assert _constant(b2, "NTHREADS") == mc33._EXT_THREADS
    b3 = _build.source("ntri.cu")
    assert (_constant(b3, "NTHREADS"), _constant(b3, "BLOCKS_PER_SM")) == (
        mc._NTRI_THREADS, mc._NTRI_BLOCKS_PER_SM)
    # the blocks of an SM fill its 2,048 threads
    assert mc._NTRI_THREADS * mc._NTRI_BLOCKS_PER_SM == 2048
    b6 = _build.source("eval_tiles.cu")
    assert (_constant(b6, "NTHREADS"), _constant(b6, "CLUSTER"),
            _constant(b6, "SMEM_MAX")) == (
        ec._TILE_THREADS, ec._TILE_CLUSTER, ec._TILE_SMEM)
    # 227 KB, the H100's most shared memory for one block; warps of 32
    assert ec._TILE_SMEM == 232448 and ec._TILE_THREADS % 32 == 0


def test_wrappers_call_entries_the_sources_define():
    """Every C entry point the wrappers look up is defined in its source."""
    b1 = ec.kernel_source(sp.sphere(1))
    for dt in ("f32", "f64"):
        name = "sdf_eval_classify_" + dt
        assert 'extern "C" int %s(' % name in b1, name
    b4 = _build.source("compact.cu")
    for name in ("sdf_compact_indices", "sdf_compact_ranktable"):
        assert 'extern "C" int %s(' % name in b4, name
    b2 = mc33.kernel_source()
    for name in ("sdf_classify_ext_f32", "sdf_classify_ext_f64",
                 "sdf_ext_from_bits"):
        assert 'extern "C" int %s(' % name in b2, name
    # the per-cell body is spliced in, not included from a path
    assert '#include "mc33_cell.cuh"' not in b2 and "interior_code(" in b2
    assert 'extern "C" int sdf_ntri(' in _build.source("ntri.cu")


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


# --- B6/B7: tile rows cut into slabs ------------------------------------------


def _brick_evaluations(tile):
    """Samples a tile row cost under the bricks of 4 x 8 x 32 cells that
    eval_tiles.cu used before slabs: every brick evaluated its cells'
    samples plus one along each axis, as far as the tile reached."""
    TS = tile + 1

    def axis(cells):
        return sum(min(cells + 1, TS - a) for a in range(0, tile, cells))

    return axis(4) * axis(8) * axis(32)


SMS = 132  # an H100 SXM's SMs


def _emulate_tiles(vol, blocks=None, csize=None):
    """csrc/eval_tiles.cu's index rules in numpy, on one tile row ``vol``
    (TS, TS, TS): per block, each thread's samples from its first index
    and the (dx, dy, dz) steps with their carries, the samples it writes to
    ``vols``, the ballot words of the sign bits; the halo words each block
    but a cluster's last copies from the next block of its cluster; then
    each thread's cells, their case codes from four funnel-shifted bit
    pairs, and their index in ``cas``.  Unwritten bit words hold ones, so a
    read of one shows.  Returns (writes per sample, evaluations, writes
    per cell, case codes)."""
    TS = vol.shape[0]
    tile, NT = TS - 1, ec._TILE_THREADS
    plane, N = TS * TS, TS ** 3
    S, nblk, csize, smem = ec.tile_plan(tile, 1, SMS, blocks, csize)
    nwords = smem // 4
    inside = (np.asarray(vol) < 0).reshape(-1)
    writes = np.zeros(N, np.int64)
    cwrites = np.zeros(tile ** 3, np.int64)
    case = np.full(tile ** 3, -1, np.int64)
    evals = 0
    tid = np.arange(NT)
    lane = tid % 32
    dz, dy, dx = NT % TS, NT // TS % TS, NT // plane

    def start(p):
        y = p // TS
        return p % TS, y % TS, y // TS

    def step(x, y, z):
        z = z + dz
        zc = z >= TS
        z = z - zc * TS
        y = y + dy + zc
        yc = y >= TS
        y = y - yc * TS
        return x + dx + yc, y, z

    bits = np.full((nblk, nwords), 0xFFFFFFFF, np.uint64)
    written = np.zeros((nblk, nwords), bool)
    for b in range(nblk):
        rank = b % csize
        s0 = min(b * S, N)
        s1 = min(s0 + S, N)
        e = min(s1 + plane + TS + 1, N) if rank == csize - 1 else s1
        p = s0 + tid
        z, y, x = start(p)
        while (p - lane < e).any():
            m = p < e
            np.testing.assert_array_equal(p[m], ((x * TS + y) * TS + z)[m])
            evals += int(m.sum())
            np.add.at(writes, p[m & (p < s1)], 1)
            ins = np.zeros(NT, bool)
            ins[m] = inside[p[m]]
            words = np.packbits(ins.reshape(-1, 32), axis=1,
                                bitorder="little").view("<u4").reshape(-1)
            go = (p - lane)[::32] < e
            at = ((p - lane)[::32][go] - s0) >> 5
            bits[b, at], written[b, at] = words[go], True
            x, y, z = step(x, y, z)
            p = p + NT
    own = S // 32
    for b in range(nblk):  # after the first cluster barrier
        if b % csize < csize - 1:
            halo = ec._tile_words(S, TS) - own
            bits[b, own: own + halo] = bits[b + 1, :halo]
            written[b, own: own + halo] = written[b + 1, :halo]
    for b in range(nblk):  # after the second
        s0 = min(b * S, N)
        s1 = min(s0 + S, N)
        q = s0 + tid
        z, y, x = start(q)
        while (q < s1).any():
            m = (q < s1) & (x < tile) & (y < tile) & (z < tile)
            ql = (q - s0)[m]

            def pair(l):
                assert written[b, l >> 5].all()
                assert written[b, (l + 1) >> 5].all()
                w = bits[b, l >> 5] | (bits[b, (l >> 5) + 1] << np.uint64(32))
                return ((w >> (l & 31).astype(np.uint64)) & np.uint64(3)
                        ).astype(np.int64)

            a, c = pair(ql), pair(ql + plane)
            d, f = pair(ql + plane + TS), pair(ql + TS)
            at = ((x * tile + y) * tile + z)[m]
            np.add.at(cwrites, at, 1)
            case[at] = (a & 1) | (c & 1) << 1 | (d & 1) << 2 | (f & 1) << 3 \
                | (a >> 1) << 4 | (c >> 1) << 5 | (d >> 1) << 6 \
                | (f >> 1) << 7
            x, y, z = step(x, y, z)
            q = q + NT
    return writes, evals, cwrites, case.reshape((tile,) * 3)


def _tile_row(tile, seed):
    """A random tile volume with exact zeros and NaNs (neither is
    inside)."""
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((tile + 1,) * 3)
    vol.reshape(-1)[rng.permutation(vol.size)[:vol.size // 10]] = 0.0
    vol.reshape(-1)[rng.permutation(vol.size)[:vol.size // 20]] = np.nan
    return vol


TILES = [1, 2, 7, 8, 16, 31, 32, 33, 63, 64, 65, 203]


@pytest.mark.parametrize("tile", TILES)
def test_tile_plan_owns_every_sample_and_cell_once(tile):
    """At every tile the wrappers are given (1 to 64, lewiner's word-pack
    limit; 65; 203, the 8-bit variant's): every sample of a row is written
    by exactly one block and every cell classified exactly once, the
    evaluations are tile_evaluations', and the case codes from the ballot
    words' funnel-shifted bit pairs, the halo copied from the next block
    of the cluster, are the plain classification's."""
    vol = _tile_row(tile, tile)
    writes, evals, cwrites, case = _emulate_tiles(vol)
    assert (writes == 1).all() and (cwrites == 1).all()
    assert evals == ec.tile_evaluations(tile, 1, SMS)
    want = mc._cell_cases(torch.as_tensor(vol)).numpy()
    np.testing.assert_array_equal(case, want)


@pytest.mark.parametrize("tile, blocks, csize", [
    (8, 4, 1), (8, 3, 3), (7, 2, 1), (16, 6, 3), (32, 16, 8), (32, 8, 2),
    (32, 2, 2), (33, 5, 5), (9, 1, 1)])
def test_forced_tile_plans_own_every_sample_and_cell_once(tile, blocks,
                                                          csize):
    """Cuts the card tests force: clusters of one block (each evaluates its
    halo), rows of several clusters (as from tile 243 on) and clusters that
    take their halos from short ranges."""
    vol = _tile_row(tile, 7 * tile + blocks)
    writes, evals, cwrites, case = _emulate_tiles(vol, blocks, csize)
    assert (writes == 1).all() and (cwrites == 1).all()
    assert evals == ec.tile_evaluations(tile, 1, SMS, blocks, csize)
    np.testing.assert_array_equal(
        case, mc._cell_cases(torch.as_tensor(vol)).numpy())


@pytest.mark.parametrize("tile", TILES)
def test_tile_plan_evaluates_each_sample_about_once(tile):
    """Once each up to tile 242 (the bricks took 1.32 at tile 32), at no
    tile more than the bricks, and within 227 KB of shared memory."""
    evals = ec.tile_evaluations(tile, 1, SMS)
    assert evals == (tile + 1) ** 3
    assert evals <= _brick_evaluations(tile)
    assert ec.tile_plan(tile, 1, SMS)[3] <= ec._TILE_SMEM
    if tile == 32:
        assert _brick_evaluations(32) == 40 * 36 * 33


@pytest.mark.parametrize("tile", [243, 300, 400, 962])
def test_tile_plan_cuts_large_tiles_into_clusters(tile):
    """Past tile 242 a row's sign bits outgrow 8 blocks' shared memory: the
    row is cut into several clusters, each of which but the last evaluates
    its halo, still below the bricks (which ended at tile 400, their
    65,535th block)."""
    S, blocks, csize, smem = ec.tile_plan(tile, 1, SMS)
    assert csize == ec._TILE_CLUSTER and blocks > csize
    assert smem <= ec._TILE_SMEM
    evals = ec.tile_evaluations(tile, 1, SMS)
    assert evals <= _brick_evaluations(tile)
    if tile <= 400:
        assert evals <= 1.01 * (tile + 1) ** 3
    if tile == 962:  # the last tile whose halo fits a block
        with pytest.raises(ValueError, match="no plan"):
            ec.tile_plan(963, 1, SMS)


def test_tile_plan_counts_and_limits():
    # tile 32, one row: a cluster of 8 blocks of 4,512 samples
    assert ec.tile_plan(32, 1, SMS) == (
        4512, 8, 8, 4 * ((4511 + 33 * 33 + 33) // 32 + 2))
    # blobby's routed run evaluates 388 rows: 2 blocks a row fill the 528
    # that 132 SMs hold at 4 each; the example's 173 take 4; a card of
    # half the SMs takes half the blocks
    assert ec.tile_plan(32, 388, SMS)[:3] == (17984, 2, 2)
    assert 388 * 2 >= SMS * ec._TILE_BLOCKS_PER_SM > 388
    assert ec.tile_plan(32, 173, SMS)[1:3] == (4, 4)
    assert ec.tile_plan(32, 173, SMS // 2)[1:3] == (2, 2)
    # many rows: one block each; small tiles: no more than BLOCK_MIN allow
    assert ec.tile_plan(32, 10**5, SMS)[1:3] == (1, 1)
    assert ec.tile_plan(8, 1, SMS)[1:3] == (1, 1)
    assert ec.tile_plan(16, 1, SMS)[1:3] == (2, 2)
    assert ec.tile_plan(242, 1, SMS)[1] == 8
    assert ec.tile_plan(243, 1, SMS)[1] == 16
    with pytest.raises(ValueError, match=">= 1"):
        ec.tile_plan(0, 1, SMS)
    with pytest.raises(ValueError, match="no plan"):
        ec.tile_plan(32, 1, SMS, 8, 3)  # clusters must divide the row
    with pytest.raises(ValueError, match="no plan"):
        ec.tile_plan(32, 1, SMS, 64, 8)  # a range shorter than a halo


# --- B4: one-pass compaction -------------------------------------------------


def _granule_bits(mask, v, off):
    """The True bits of the granule at virtual slot ``v`` (load_granule)."""
    i, bits = v - off, 0
    for s in range(max(i, 0), min(i + 16, len(mask))):
        if mask[s]:
            bits |= 1 << (s - i)
    return bits


def _emulate_b4(mask, off, capacity, table=None):
    """csrc/compact.cu indices_kernel in numpy, on a mask whose first byte
    sits ``off`` bytes past a 16-byte boundary: the chunks' granules, the
    per-warp and per-block scans in their order, the prefix of the earlier
    chunks, and the scatter; returns (out, count, slots read).  With
    ``table`` (an int64 array of 2 * ceil(n / 32) entries, -1 = unwritten)
    also B5's table writes: the even lanes' pairs from their granule, the
    next lane's and the one after (lane 30 reads that one from the mask
    again), each entry written exactly once."""
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
                v = v0 + (k * threads + t) * 16
                g = v >> 5
                if table is not None and lane % 2 == 0 and g < -(-n // 32):
                    b0, b1 = int(bits[k, t]), int(bits[k, t + 1])
                    b2 = (_granule_bits(mask, v + 32, off) if lane == 30
                          else int(bits[k, t + 2]))
                    word = (b0 >> off) | (b1 << (16 - off))
                    if off:
                        word |= b2 << (32 - off)
                    assert table[2 * g] == -1 and table[2 * g + 1] == -1
                    table[2 * g] = r + bin(b0 & ((1 << off) - 1)).count("1")
                    table[2 * g + 1] = word & 0xFFFFFFFF
                i0 = v - off
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


@pytest.mark.parametrize("off", [0, 1, 7, 15])
@pytest.mark.parametrize("n, density", [(1, 1.0), (31, 0.5), (37, 0.5),
                                        (16384 + 13, 0.3), (40000, 1e-3),
                                        (2 * 16384, 1.0), (20000, 0.0)])
def test_one_pass_ranktable_plan(n, density, off):
    """Kernel B5's table writes (B4's launch with TABLE): every 32-slot
    group's pair is written exactly once, by the lane holding the group's
    first granule, and equals the plain version's, at every alignment;
    the last group of a ragged mask holds its valid bits only."""
    mask = np.random.default_rng(7 * n + off).random(n) < density
    total = int(mask.sum())
    for cap in (total + 33, max(1, total // 2)):
        table = np.full(2 * (-(-n // 32)), -1, np.int64)
        got, count, _ = _emulate_b4(mask, off, cap, table)
        want_idx, want_tab, want_count = compact._ranktable_plain(
            torch.as_tensor(mask), cap)
        np.testing.assert_array_equal(got, want_idx.numpy())
        assert count == int(want_count)
        np.testing.assert_array_equal(
            table.astype(np.uint32).view(np.int32), want_tab.numpy())


def test_indices_plan_counts():
    assert compact.indices_plan(0, 16384, 0) == (0, 1, 0)
    assert compact.indices_plan(17, 16384, 1) == (1, 2, 1)
    assert compact.indices_plan(32, 2**24 + 13, 2**22) == (0, 1025, 256)
    _, nchunks, ntail = compact.indices_plan(15, 2**31 - 1, 5000)
    assert nchunks == -(-(2**31 + 14) // 16384) and ntail == 2


# --- B2: row blocks of the cell plane, marched along x -----------------------


def _emulate_b2(nb, nx, ny, nz, lx):
    """csrc/classify_ext.cu's index rules in numpy, for ``nb`` volumes of
    ``nx x ny x nz`` samples: per block, the lanes' cells and
    rows from the plan's multiplier, and per step the four corners each
    lane loads from the new sample plane beside the four it carries from
    the old one.  Returns the writes per cell and the flat sample index of
    each cell's 8 corners (CORNER_OFFSETS order)."""
    nrb, nslab, mul, shift, blocks = mc33.ext_plan(nb, nx, ny, nz, lx)
    nt = mc33._EXT_THREADS
    cplane, plane = (ny - 1) * (nz - 1), ny * nz
    row = lambda p: ((np.asarray(p, np.uint64) * np.uint64(mul))
                     >> np.uint64(shift)).astype(np.int64)
    ncell = nb * (nx - 1) * cplane
    writes = np.zeros(ncell, np.int64)
    corners = np.full((ncell, 8), -1, np.int64)
    for blk in range(blocks):
        bs, rb = divmod(blk, nrb)
        b, slab = divmod(bs, nslab)
        x0 = slab * lx
        x1 = min(x0 + lx, nx - 1)
        p = rb * nt + np.arange(nt)
        p = p[p < cplane]
        a = (b * nx + x0) * plane + p + row(p)  # sample (y, z) is p + y
        r = a + nz
        lo = [a, a + 1, r, r + 1]  # (y, z) (y, z + 1) (y + 1, z) (y + 1, z + 1)
        hi = [t + plane for t in lo]
        for x in range(x0, x1):
            cell = (b * (nx - 1) + x) * cplane + p
            writes[cell] += 1
            corners[cell] = np.stack([lo[0], hi[0], hi[2], lo[2], lo[1],
                                      hi[1], hi[3], lo[3]], axis=1)
            lo, hi = hi, [t + plane for t in hi]
    return writes, corners


def _corner_samples(nb, nx, ny, nz):
    """The flat sample index of each cell's 8 corners, as CORNER_OFFSETS
    places them."""
    b, x, y, z = np.meshgrid(np.arange(nb), np.arange(nx - 1),
                             np.arange(ny - 1), np.arange(nz - 1),
                             indexing="ij")
    return np.stack([((b * nx + x + ox) * ny + y + oy) * nz + z + oz
                     for ox, oy, oz in CORNER_OFFSETS.tolist()],
                    axis=-1).reshape(-1, 8)


B2_SHAPES = [(1, 2, 2, 2), (13, 2, 2, 2), (1, 2, 37, 3), (1, 3, 2, 41),
             (1, 37, 41, 43), (2, 17, 19, 23), (1, 4, 5, 162),
             (1, 3, 3, 407), (1, 20, 3, 162), (3, 33, 33, 33),
             (2, 5, 300, 2), (1, 2, 2, 1001)]


@pytest.mark.parametrize("lx", [mc33.EXT_SLAB, 1, 7, 32])
@pytest.mark.parametrize("shape", B2_SHAPES)
def test_ext_plan_classifies_every_cell_once(shape, lx):
    """Axes of 2, primes, rows of 161 and 406 cells, rows of one cell,
    tile volumes (33^3) in a batch: every cell is written by exactly one
    lane of one block, and its 8 corners are read from the samples at
    CORNER_OFFSETS."""
    writes, corners = _emulate_b2(*shape, lx)
    assert (writes == 1).all()
    np.testing.assert_array_equal(corners, _corner_samples(*shape))


@pytest.mark.parametrize("shape", [(2, 6, 7, 9), (1, 5, 9, 34), (3, 3, 2, 5)])
def test_marched_corners_give_the_plain_ext_grid(shape):
    """The corners the mirror loads, through the plain per-cell functions,
    give the plain version's ext grid (random volume with exact zeros, at
    a nonzero level, with and without base_case)."""
    nb, nx, ny, nz = shape
    rng = np.random.default_rng(nx * ny * nz)
    vol = rng.standard_normal(shape)
    vol.reshape(-1)[rng.permutation(vol.size)[: vol.size // 8]] = 0.125
    vol = torch.as_tensor(vol)
    _, corners = _emulate_b2(*shape, 2)
    c = [vol.reshape(-1)[torch.as_tensor(corners[:, i])] - 0.125
         for i in range(8)]
    case = torch.zeros(c[0].shape, dtype=torch.int32)
    for i in range(8):
        case |= (c[i] < 0).to(torch.int32) << i
    got = mc33._ext_from_bits_plain(case, mc33.extra_bits(c))
    cshape = (nb, nx - 1, ny - 1, nz - 1)
    want = mc33._classify_ext_plain(vol, 0.125)
    assert torch.equal(got.reshape(cshape), want)
    base = torch.as_tensor(rng.integers(0, 256, cshape).astype(np.int32))
    got = mc33._ext_from_bits_plain(base.reshape(-1), mc33.extra_bits(c))
    assert torch.equal(got.reshape(cshape),
                       mc33._classify_ext_plain(vol, 0.125, base))


@pytest.mark.parametrize("cz", [1, 2, 3, 31, 32, 161, 406, 641, 65537,
                                2**30 + 1, 2**31 - 1])
def test_ext_plan_row_multiplier_is_exact(cz):
    """p * mul >> shift == p // cz for p below 2**31: the plane's edges,
    the multiples of cz and their neighbours, and random p."""
    _, _, mul, shift, _ = mc33.ext_plan(1, 2, 2, cz + 1)
    rng = np.random.default_rng(cz)
    k = rng.integers(0, (2**31 - 1) // cz + 1, 2000)
    p = np.concatenate([np.arange(1000), 2**31 - 1 - np.arange(1000),
                        k * cz, k * cz - 1, k * cz + 1,
                        rng.integers(0, 2**31, 5000)])
    p = p[(p >= 0) & (p < 2**31)].astype(np.uint64)
    got = (p * np.uint64(mul)) >> np.uint64(shift)
    np.testing.assert_array_equal(got, p // np.uint64(cz))
    assert mul < 2**33 and shift <= 62


def test_ext_plan_counts_and_limits():
    # the main path's shapes: 162^3, 407^3, 512 tile volumes
    assert mc33.ext_plan(1, 162, 162, 162, 8)[:2] == (102, 21)
    assert mc33.ext_plan(1, 407, 407, 407, 16)[0:2] == (644, 26)
    assert mc33.ext_plan(512, 33, 33, 33, 8)[4] == 512 * 4 * 4
    with pytest.raises(ValueError, match="2\\*\\*31"):
        mc33.ext_plan(1, 2, 2**16 + 2, 2**15 + 2)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        mc33.ext_plan(2**31, 2, 2, 2)


# --- B3: head, 16-byte vectors, tail -----------------------------------------


def _emulate_b3(codes, off, table, ncase, sms):
    """csrc/ntri.cu in numpy, on ``codes`` whose first element sits ``off``
    int32 past a 16-byte boundary: block 0's lanes do the head and the
    tail one code each, every lane its vectors two at a time at a grid
    stride.  Returns (out, reads per code, vector addresses)."""
    n = len(codes)
    base = 4096 + 4 * off
    head, nvec, tail, blocks = mc.ntri_plan(base, n, sms)
    out = np.full(n, -1, np.int64)
    reads = np.zeros(n, np.int64)
    look = lambda c: np.where((c >= 0) & (c < ncase),
                              table[np.clip(c, 0, ncase - 1)], 0)

    def put(i):
        reads[i] += 1
        assert (out[i] == -1).all()
        out[i] = look(codes[i])

    for t in range(8):  # block 0's head and tail lanes
        i = (t if t < head else n) if t < 4 else head + 4 * nvec + t - 4
        if i < n:
            put(np.array([i]))
    stride = blocks * mc._NTRI_THREADS
    v = np.arange(stride)
    addrs = []
    while (v < nvec).any():
        for u in (v, v + stride):
            u = u[u < nvec]
            addrs.append(base + 4 * head + 16 * u)
            put((head + 4 * u[:, None] + np.arange(4)).reshape(-1))
        v = v + 2 * stride
    return out, reads, (np.concatenate(addrs) if addrs else np.zeros(0))


@pytest.mark.parametrize("variant", ["fast", "lewiner"])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 5, 4 * 7 + 1, 4 * 2048 + 1,
                               4 * 9000 + 3, 20011])
def test_ntri_plan_covers_every_code_once(n, off, variant):
    """At int32 offsets 0-3 from a 16-byte boundary and lengths 0, 1, 3,
    4k + 1 and past one grid stride: every code is looked up once, every
    vector access is 16-byte aligned, and the output is the plain
    lookup's, codes outside the table included."""
    tab = mc.get_tables(variant)
    rng = np.random.default_rng(n + off)
    codes = rng.integers(-3, tab.ncase + 3, n)
    out, reads, addrs = _emulate_b3(codes, off, tab.ntri_u8, tab.ncase,
                                    sms=3)
    assert (reads == 1).all() and (addrs % 16 == 0).all()
    want = mc._ntri_plain(torch.as_tensor(codes.astype(np.int32)),
                          torch.as_tensor(tab.ntri))
    np.testing.assert_array_equal(out, want.numpy())


def test_ntri_plan_counts():
    sms = 132
    assert mc.ntri_plan(0, 0, sms) == (0, 0, 0, 1)
    assert mc.ntri_plan(4, 1, sms) == (1, 0, 0, 1)
    assert mc.ntri_plan(4, 3, sms) == (3, 0, 0, 1)
    assert mc.ntri_plan(8, 7, sms) == (2, 1, 1, 1)
    n = 161**3  # the example's cells: the grid fills the card
    assert mc.ntri_plan(512, n, sms) == (0, n // 4, n % 4, sms * 8)
    with pytest.raises(ValueError, match="multiple of 4"):
        mc.ntri_plan(6, 10, sms)


@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_ntri_output_takes_the_input_alignment(off):
    """The wrapper's output starts at the input's address modulo 16, so one
    head serves both."""
    case = torch.zeros(100, dtype=torch.int32)[off:]
    out = mc._like_at(case, case.data_ptr())
    assert out.shape == case.shape and out.dtype == torch.int32
    assert (out.data_ptr() - case.data_ptr()) % 16 == 0


@pytest.mark.parametrize("variant", ["fast", "lewiner"])
def test_byte_table_equals_the_int32_table(variant):
    tab = mc.get_tables(variant)
    u8 = tab.on("cpu", "ntri_u8")
    assert u8.dtype == torch.uint8 and u8.numel() % 16 == 0
    assert u8.numel() - tab.ncase < 16
    assert torch.equal(u8[: tab.ncase].to(torch.int32),
                       tab.on("cpu", "ntri"))
    assert not u8[tab.ncase:].any()
