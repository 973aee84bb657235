"""Stream compaction: indices of True elements, in order (counterpart of
``sdf_tpu.core.compact``).

``indices_of(mask, capacity)`` has the contract of
``jnp.flatnonzero(mask, size=capacity, fill_value=0)`` plus the count;
``indices_and_ranktable_of`` adds a compact rank structure, 2 words per
32 slots (exclusive offset, bitmask word), from which ``rank_lookup``
recovers the compacted rank of any True slot.

On a CUDA tensor they launch the kernels of ``csrc/compact.cu`` and never
sync with the host: the count stays a device tensor.  ``indices_of`` is
kernel B4, one launch that reads the mask once (a single-pass scan with
decoupled look-back); ``indices_and_ranktable_of`` is kernel B5, the same
one launch writing the rank table beside the indices.  On a CPU tensor they run the
plain versions below, which the tests hold against the JAX package and
``chip_smoke.py`` holds the kernels against.  The TPU-only helpers of the
JAX module (``gather1d``, the 128-lane row tricks) have no counterpart:
plain indexing serves.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

# Kernels B4 and B5's launch plan (csrc/compact.cu): a chunk is IDX_CHUNK slots;
# at most _TAIL_BLOCKS blocks, one per _TAIL_SLOTS output words, zero the
# output's tail.
_IDX_CHUNK = 256 * 4 * 16
_TAIL_SLOTS = 4096
_TAIL_BLOCKS = 256


def _lib():
    lib = _build.load("compact", _build.source("compact.cu"))
    if not getattr(lib, "_sdf_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.sdf_compact_indices.argtypes = [vp, i64, i32, i32, i32, vp, i64,
                                            vp, vp, vp]
        lib.sdf_compact_ranktable.argtypes = [vp, i64, i32, i32, i32, vp,
                                              i64, vp, vp, vp, vp]
        for fn in (lib.sdf_compact_indices, lib.sdf_compact_ranktable):
            fn.restype = ctypes.c_int
        lib._sdf_typed = True
    return lib


def _check_mask(mask, capacity):
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise ValueError("mask must be a 1D bool tensor")
    if mask.numel() >= 2**31:
        raise ValueError("mask too long for int32 indices")
    if capacity < 0:
        raise ValueError("capacity must be >= 0")


def indices_plan(address, n, capacity):
    """Kernels B4 and B5's launch plan for a mask of ``n`` slots at device address
    ``address``: ``(off, nchunks, ntail)``.  The kernel reads the 16-byte
    granules of the aligned space that holds the mask, so slot ``i`` is
    virtual slot ``i + off``; ``nchunks`` chunks of ``_IDX_CHUNK`` virtual
    slots cover it, and ``ntail`` more blocks zero the output's tail."""
    off = address % 16
    nchunks = -(-(off + n) // _IDX_CHUNK)
    ntail = min(_TAIL_BLOCKS, -(-capacity // _TAIL_SLOTS))
    return off, nchunks, ntail


def _indices_cuda(mask, capacity):
    """Kernel B4: one launch after a memset of its scratch (the look-back
    status words and the chunk ticket); returns ``(idx, count)``.  Adds one
    to ``indices_of.launches`` when it launches (an empty mask launches
    nothing)."""
    _build.require_cuda(mask, "indices_of")
    dev = mask.device
    n = mask.numel()
    if n == 0:
        return (torch.zeros(capacity, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    lib = _lib()
    off, nchunks, ntail = indices_plan(mask.data_ptr(), n, capacity)
    out = torch.empty(capacity, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(nchunks + 1, dtype=torch.int64, device=dev)
    _build.check(
        lib.sdf_compact_indices(
            mask.data_ptr(), n, off, nchunks, ntail, out.data_ptr(), capacity,
            count.data_ptr(), scratch.data_ptr(), _build.stream_ptr(dev),
        ),
        "compact indices",
    )
    indices_of.launches += 1
    return out, count


def _ranktable_cuda(mask, capacity):
    """Kernel B5: B4's one launch after one memset, also writing the rank
    table; returns ``(idx, table, total)``.  Adds one to
    ``indices_and_ranktable_of.launches`` when it launches (an empty mask
    launches nothing)."""
    _build.require_cuda(mask, "indices_and_ranktable_of")
    dev = mask.device
    n = mask.numel()
    table = torch.empty(2 * (-(-n // 32)), dtype=torch.int32, device=dev)
    if n == 0:
        return (torch.zeros(capacity, dtype=torch.int32, device=dev), table,
                torch.zeros((), dtype=torch.int32, device=dev))
    lib = _lib()
    off, nchunks, ntail = indices_plan(mask.data_ptr(), n, capacity)
    out = torch.empty(capacity, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(nchunks + 1, dtype=torch.int64, device=dev)
    _build.check(
        lib.sdf_compact_ranktable(
            mask.data_ptr(), n, off, nchunks, ntail, out.data_ptr(), capacity,
            total.data_ptr(), table.data_ptr(), scratch.data_ptr(),
            _build.stream_ptr(dev),
        ),
        "compact ranktable",
    )
    indices_and_ranktable_of.launches += 1
    return out, table, total


def _indices_of_plain(mask, capacity):
    """B4's plain version: ``torch.nonzero`` (syncs with the host)."""
    idx = torch.nonzero(mask).reshape(-1)[:capacity].to(torch.int32)
    out = torch.zeros(capacity, dtype=torch.int32, device=mask.device)
    out[: idx.numel()] = idx
    return out, mask.sum(dtype=torch.int32)


def indices_of(mask, capacity):
    """Indices of True elements of 1D bool ``mask``, ascending, padded with
    0 to ``capacity``.  Returns ``(indices int32 (capacity,), count)``,
    the count a 0-d int32 tensor on the mask's device.  Kernel B4 on CUDA."""
    _check_mask(mask, capacity)
    if mask.device.type == "cpu":
        return _indices_of_plain(mask, capacity)
    return _indices_cuda(mask, capacity)


indices_of.launches = 0


def _to_i32(w):
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _ranktable_plain(mask, capacity):
    """B5's plain version: the cumsum form of the JAX package's non-TPU
    branch; the table is int32 holding the uint32 words' bits."""
    n = mask.numel()
    ng = -(-n // 32)
    mi = torch.zeros(ng * 32, dtype=torch.int64, device=mask.device)
    mi[:n] = mask
    c = torch.cumsum(mi, 0)
    excl = (c - mi)[::32]
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << torch.arange(
        32, device=mask.device
    )
    words = (mi.reshape(ng, 32) * weights).sum(dim=1)
    table = torch.stack([excl, words], dim=1).reshape(-1)
    idx, total = _indices_of_plain(mask, capacity)
    return idx, _to_i32(table), total


def indices_and_ranktable_of(mask, capacity):
    """``indices_of`` plus a compact rank table: int32 (2 * ceil(N / 32),),
    interleaved ``[offset(g), word(g), ...]`` per group of 32 slots, the
    word's bits as uint32 (view it with numpy ``.view(np.uint32)``).
    Returns ``(indices, table, count)``.  Kernel B5 on CUDA.

    The JAX package pads its table to whole 512-row blocks; the extra
    groups would hold (total, 0) and no slot looks them up."""
    _check_mask(mask, capacity)
    if mask.device.type == "cpu":
        return _ranktable_plain(mask, capacity)
    return _ranktable_cuda(mask, capacity)


indices_and_ranktable_of.launches = 0


def popcount32(v):
    """Population count of int64 values in [0, 2^32) (SWAR bit arithmetic;
    torch has no popcount)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def rank_lookup(table, idx):
    """Rank of mask slot ``idx`` from an ``indices_and_ranktable_of``
    table: the group's offset plus the popcount of its word's bits below
    the slot.  Returns int32."""
    idx = idx.to(torch.int64)
    sub = idx >> 5
    bit = idx & 31
    off = table[2 * sub].to(torch.int64)
    word = table[2 * sub + 1].to(torch.int64) & 0xFFFFFFFF
    below = word & ((torch.ones_like(bit) << bit) - 1)
    return (off + popcount32(below)).to(torch.int32)


def ragged_expand(counts, capacity, fill=None):
    """Expand per-row ``counts`` into ``capacity`` (row, rank) pairs in
    ascending (row, rank) order (see sdf_tpu.core.compact.ragged_expand).
    Padding slots are (0, 0).  Returns ``(row, rank, total)`` (int64 index
    tensors, a 0-d total), plus ``fill[row]`` per slot when ``fill`` is
    given (``fill[0]`` on padding slots)."""
    counts = counts.to(torch.int64)
    offs = torch.cumsum(counts, 0)
    total = offs[-1]
    boff = offs - counts
    pos = torch.clamp(boff, max=capacity)
    # Row starts at capacity are dropped, as JAX's mode="drop" scatter does:
    # scatter into capacity + 1 slots and cut the last.
    starts = torch.zeros(capacity + 1, dtype=torch.int64, device=counts.device)
    starts.index_add_(0, pos, torch.ones_like(pos))
    row = torch.cumsum(starts[:capacity], 0) - 1
    j = torch.arange(capacity, device=counts.device)
    live = j < total
    row_c = torch.clamp(row, min=0)
    rank = torch.where(live, j - boff[row_c], 0)
    out = (torch.where(live, row, 0), rank, total)
    if fill is None:
        return out
    v = fill.to(torch.int64)
    return out + (torch.where(live, v[row_c], v[0]),)
