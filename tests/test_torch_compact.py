"""Stream compaction (kernels B4 and B5): the port's plain versions against
the JAX package's Pallas kernels run in interpret mode.

Tolerance: integer outputs, bit-equal.  The rank table is compared as
uint32 over the port's 2 * ceil(N / 32) entries; the JAX table is padded
to whole 512-row kernel blocks, and its extra groups hold (total, 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdf_tpu.core import compact as jc
from sdf_torch.core import compact as tc

DENSITIES = [0.0, 1e-3, 0.5, 1.0]
# Ragged sizes: across a 1024-slot CUDA block, and past one 65,536-slot
# TPU block.
SIZES = [3000, 70001]


def _mask(n, density, seed):
    rng = np.random.default_rng(seed)
    return rng.random(n) < density


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("n", SIZES)
def test_indices_of_matches_pallas(n, density):
    m = _mask(n, density, seed=n)
    cap = n + 37  # capacity > count: the tail stays 0 (one compile per n)
    want, wtot = jc.indices_of_pallas(jnp.asarray(m), cap, interpret=True)
    got, gtot = tc.indices_of(torch.as_tensor(m), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gtot) == int(wtot)
    assert got.dtype == torch.int32


@pytest.mark.parametrize("n", [17, 5000])
def test_indices_of_truncates_like_pallas(n):
    """capacity < count keeps the first ``capacity`` indices."""
    m = _mask(n, 0.5, seed=3)
    cap = max(1, int(m.sum()) // 2)
    want, wtot = jc.indices_of_pallas(jnp.asarray(m), cap, interpret=True)
    got, gtot = tc.indices_of(torch.as_tensor(m), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gtot) == int(wtot)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("n", SIZES)
def test_ranktable_matches_pallas(n, density):
    m = _mask(n, density, seed=n + 1)
    cap = n + 5  # one compile per n
    want_idx, want_tab, wtot = jc.indices_and_ranktable_of(
        jnp.asarray(m), cap, backend="tpu", _interpret=True
    )
    got_idx, got_tab, gtot = tc.indices_and_ranktable_of(torch.as_tensor(m), cap)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert int(gtot) == int(wtot)
    wt = np.asarray(want_tab).astype(np.uint32)
    gt = got_tab.numpy().view(np.uint32)
    assert len(gt) == 2 * (-(-n // 32))
    np.testing.assert_array_equal(gt, wt[: len(gt)])
    assert (wt[len(gt)::2] == np.uint32(int(wtot))).all()
    assert (wt[len(gt) + 1::2] == 0).all()
    # rank_lookup over every True slot (and some False ones) is equal.
    probe = np.concatenate([np.flatnonzero(m), np.arange(0, n, 7)])
    want_r = np.asarray(jc.rank_lookup(want_tab, jnp.asarray(probe, jnp.int32)))
    got_r = tc.rank_lookup(got_tab, torch.as_tensor(probe)).numpy()
    np.testing.assert_array_equal(got_r, want_r)
    # ... and on True slots it is the rank in the compacted stream.
    true_slots = np.flatnonzero(m)
    np.testing.assert_array_equal(
        tc.rank_lookup(got_tab, torch.as_tensor(true_slots)).numpy(),
        np.arange(len(true_slots)),
    )


def test_popcount32():
    rng = np.random.default_rng(7)
    v = rng.integers(0, 2**32, 5000, dtype=np.int64)
    v[:3] = [0, 2**32 - 1, 2**31]
    want = np.array([bin(int(x)).count("1") for x in v])
    np.testing.assert_array_equal(tc.popcount32(torch.as_tensor(v)).numpy(), want)


@pytest.mark.parametrize("with_fill", [False, True])
def test_ragged_expand_matches_jax(with_fill):
    rng = np.random.default_rng(11)
    counts = rng.integers(0, 5, 300).astype(np.int32)
    counts[:3] = 0  # zero-count rows at the front, and scattered below
    counts[100:110] = 0
    total = int(counts.sum())
    fill = rng.integers(-1000, 1000, 300).astype(np.int32)
    for cap in (total + 29, total // 2):
        kw = {"fill": jnp.asarray(fill)} if with_fill else {}
        want = jc.ragged_expand(jnp.asarray(counts), cap, **kw)
        kw = {"fill": torch.as_tensor(fill)} if with_fill else {}
        got = tc.ragged_expand(torch.as_tensor(counts), cap, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g.numpy()), np.asarray(w))


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        tc.indices_of(torch.zeros(10, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        tc.indices_and_ranktable_of(torch.zeros((2, 5), dtype=torch.bool), 4)
    meta = torch.zeros(64, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        tc.indices_of(meta, 4)


class _FakeLib:
    """Stand-in for the compiled library: records the entries called and
    returns success without touching memory."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append(name)
            return 0

        return entry


@pytest.mark.parametrize("with_table", [False, True])
@pytest.mark.parametrize("n", [0, 70])
def test_compact_counts_only_launches(monkeypatch, n, with_table):
    """The CUDA path counts a launch exactly when it calls the kernels: an
    empty mask returns before launching and counts none; B4 and B5 are one
    launch each.  Driven on the CPU with a stand-in library (the
    device checks are bypassed)."""
    lib = _FakeLib()
    monkeypatch.setattr(tc, "_lib", lambda: lib)
    monkeypatch.setattr(tc._build, "require_cuda", lambda t, what: None)
    monkeypatch.setattr(tc._build, "stream_ptr", lambda dev: None)
    wrapper = tc.indices_and_ranktable_of if with_table else tc.indices_of
    launch = tc._ranktable_cuda if with_table else tc._indices_cuda
    before = wrapper.launches
    out = launch(torch.zeros(n, dtype=torch.bool), 8)
    assert len(out) == (3 if with_table else 2) and out[0].shape == (8,)
    if n == 0:
        assert lib.calls == [] and wrapper.launches == before
    elif with_table:
        assert lib.calls == ["sdf_compact_ranktable"]
        assert wrapper.launches == before + 1
    else:
        assert lib.calls == ["sdf_compact_indices"]
        assert wrapper.launches == before + 1
    wrapper.launches = before


@pytest.mark.parametrize("n, density, cap_share", [
    (1, 1.0, 2.0), (31, 0.5, 2.0), (33, 1.0, 0.5), (64, 1.0, 1.0),
    (95, 0.3, 0.25), (1000, 1.0, 0.5), (4097, 0.0, 1.0)])
def test_ranktable_plain_at_the_edge_shapes(n, density, cap_share):
    """Kernel B5's plain version, and so its table layout, against the JAX
    package's (its non-TPU branch) where a mask's length is not a multiple
    of 32, where every slot is True, and with capacity below the count:
    indices, count and table equal, the last group holding its valid bits
    only."""
    m = _mask(n, density, seed=n + 11)
    cap = max(1, int(cap_share * max(1, int(m.sum()))))
    want_idx, want_tab, wtot = jc.indices_and_ranktable_of(jnp.asarray(m), cap)
    got_idx, got_tab, gtot = tc.indices_and_ranktable_of(torch.as_tensor(m),
                                                         cap)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert int(gtot) == int(wtot) == int(m.sum())
    gt = got_tab.numpy().view(np.uint32)
    np.testing.assert_array_equal(gt, np.asarray(want_tab).astype(np.uint32)
                                  [: len(gt)])
    last = n - 32 * (len(gt) // 2 - 1)
    assert gt[-1] >> last == 0 if last < 32 else True


def test_ranktable_of_an_empty_mask():
    idx, table, total = tc.indices_and_ranktable_of(
        torch.zeros(0, dtype=torch.bool), 4)
    assert idx.tolist() == [0, 0, 0, 0] and table.numel() == 0
    assert int(total) == 0 and total.dim() == 0
