"""Runtime side of the lewiner MC variant (``mc_variant="lewiner"``, the
default): extended-case classification (counterpart of
``sdf_tpu.core.mc33``).

The table set is addressed by ``ext = OFFSET[case] + facebits * 9 + ibits``
(see ``mc33_build``): ``facebits`` holds the bilinear-saddle sign of each
ambiguous face (Lewiner's face test) and ``ibits`` in [0, 9) the
per-saddle-index interior code of the trilinear's body saddles.  OFFSET
reaches 5,895, a WEIGHT at most 288, ext lies in [0, 5904).

``classify_ext`` computes that code per cell from the evaluated volume.
On a CUDA tensor it launches kernel B2 (``csrc/classify_ext.cu``, the
per-cell body in ``csrc/mc33_cell.cuh``): row blocks of the flattened (y,
z) cell plane march along x, a lane down each cell column (``ext_plan``),
and each cell runs the face and interior tests and looks the per-case
constants up.  ``ext_from_bits`` is the table part
alone, the contract of the TPU kernel it replaces, and launches the
second kernel of the same file.  On a CPU tensor both run the plain
versions below, which perform the same single IEEE operations in the same
order (the tests hold them bit-equal to the JAX package evaluated eagerly,
``chip_smoke.py`` holds the kernels bit-equal to them on the card).  The
JAX package resolves the constants with a bf16 one-hot matmul because
TPU gathers are slow; here the lookup is a lookup.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from .. import _build
from . import mc33_build as mb
from .mc_tables import CORNER_OFFSETS, _FACES
from .node import upload

_NPZ = os.path.join(os.path.dirname(__file__), "mc33_tables.npz")


@functools.lru_cache()
def load_tables():
    """The committed table artifact (``tri_table`` (5904, 10, 3), ``ntri``,
    ``offset``, ``weight``, ``realizable``, ``ncomp``, ``conflict_rate``),
    checked against the offsets ``mc33_build.build_offsets`` derives.
    Callers must not write into the arrays: they are shared."""
    if not os.path.exists(_NPZ):
        raise FileNotFoundError(
            f"{_NPZ} missing -- it is a copy of the JAX package's "
            "sdf_tpu/core/mc33_tables.npz"
        )
    with np.load(_NPZ) as z:
        d = dict(z)
    if not (
        np.array_equal(d["offset"], mb.OFFSET)
        and np.array_equal(d["weight"], mb.WEIGHT)
    ):
        raise ValueError(
            "mc33_tables.npz layout does not match mc33_build.build_offsets()"
        )
    d["tri_table"] = d["tri_table"].astype(np.int32)
    return d


_OFFW_DEV = {}  # device -> (256 * 7,) int32 [OFFSET | WEIGHT row-major]


def _offw(device):
    """OFFSET (256) then WEIGHT (256 x 6, row-major) as one int32 tensor on
    ``device`` (cached): the layout both kernels of classify_ext.cu read."""
    key = str(device)
    if key not in _OFFW_DEV:
        d = load_tables()
        flat = np.concatenate([d["offset"].reshape(-1), d["weight"].reshape(-1)])
        _OFFW_DEV[key] = upload([flat], torch.int32, device)[0]
    return _OFFW_DEV[key]


def extra_bits(c):
    """Packed per-cell topology-resolution bits from the 8 corner tensors
    ``c`` (CORNER_OFFSETS order, one common shape): int32
    ``facebits | ibits9 << 6`` with ``ibits9 = s1 + 3 * s2`` in [0, 9).

    Face test: joined iff the bilinear saddle value is inside, i.e.
    ``(a c - b d)`` and ``(a + c - b - d)`` have opposite signs.  The bit is
    computed on unambiguous faces too (their table weights are zero).  The
    interior test is ``mc33_build.interior_flags``."""
    fb = torch.zeros(c[0].shape, dtype=torch.int32, device=c[0].device)
    for f, corners in enumerate(_FACES):
        a, b, cc, dd = (c[i] for i in corners)
        joined = ((a * cc - b * dd) * (a + cc - b - dd)) < 0
        fb |= joined.to(torch.int32) << f
    neg1, pos1, neg2, pos2 = mb.interior_flags(
        c, float(torch.finfo(c[0].dtype).eps))
    s1 = torch.where(neg1, 1, torch.where(pos1, 2, 0)).to(torch.int32)
    s2 = torch.where(neg2, 1, torch.where(pos2, 2, 0)).to(torch.int32)
    return fb | ((s1 + 3 * s2) << 6)


def _ext_from_bits_plain(case, extra):
    """The table part's plain version: ``OFFSET[case] + sum_f bit_f(extra)
    * WEIGHT[case, f] + ((extra >> 6) & 15)``; a case outside [0, 256)
    contributes no offset and no weight (as the one-hot form gives)."""
    tab = _offw(case.device)
    ok = (case >= 0) & (case < 256)
    cl = case.clamp(0, 255).long()
    ext = torch.where(ok, tab[cl], 0)
    for f in range(6):
        w = tab[256 + cl * 6 + f]
        ext = ext + torch.where(ok & (((extra >> f) & 1) > 0), w, 0)
    return (ext + ((extra >> 6) & 15)).to(torch.int32)


_CELL_INCLUDE = '#include "mc33_cell.cuh"'


def kernel_source():
    """The CUDA source of kernel B2: ``csrc/classify_ext.cu`` with the
    per-cell body ``csrc/mc33_cell.cuh`` spliced in at its include line."""
    return _build.source("classify_ext.cu").replace(
        _CELL_INCLUDE, _build.source("mc33_cell.cuh"))


# Kernel B2's launch plan (csrc/classify_ext.cu NTHREADS): a block is a
# row block of _EXT_THREADS consecutive cells of the flattened (y, z) cell
# plane of one batch volume, marched along a slab of EXT_SLAB cell planes.
# Slabs of 8 (chip_smoke.py --slab-sweep on the H100): float64 at 162^3
# needs them to stay ahead of the one-cell-a-thread kernel this replaced;
# float32 at 407^3 would be 3% faster with 16.
_EXT_THREADS = 256
EXT_SLAB = 8


def ext_plan(nb, nx, ny, nz, lx=EXT_SLAB):
    """Kernel B2's launch plan for ``nb`` volumes of ``nx x ny x nz``
    samples with slabs of ``lx`` cell planes: ``(nrb, nslab, mul, shift,
    blocks)``, the row blocks of a cell plane, the slabs of a volume, the
    multiplier and shift that give a cell's row ``p // cz == p * mul >>
    shift`` for every ``p < 2**31`` (``cz = nz - 1``; the round-up
    reciprocal, exact because ``2**(shift - 31) >= cz``), and the blocks
    of the launch.  Raises for a cell plane or a launch of 2**31 cells or
    blocks or more."""
    cz = nz - 1
    cplane = (ny - 1) * cz
    nrb = -(-cplane // _EXT_THREADS)
    nslab = -(-(nx - 1) // lx)
    blocks = nb * nslab * nrb
    if cplane >= 2**31 or blocks >= 2**31:
        raise ValueError(
            "classify_ext: %d cells a plane and %d blocks; both must be "
            "below 2**31" % (cplane, blocks))
    shift = 31 + (cz - 1).bit_length()
    return nrb, nslab, -(-(1 << shift) // cz), shift, blocks


def _lib():
    lib = _build.load("classify_ext", kernel_source())
    if not getattr(lib, "_sdf_typed", False):
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        u, u64 = ctypes.c_uint, ctypes.c_uint64
        for name in ("sdf_classify_ext_f32", "sdf_classify_ext_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, i64, i, i, i, i, u, u, u64, i, u,
                           ctypes.c_double, vp, vp, vp, vp]
            fn.restype = ctypes.c_int
        lib.sdf_ext_from_bits.argtypes = [vp, vp, i64, vp, vp, vp]
        lib.sdf_ext_from_bits.restype = ctypes.c_int
        lib._sdf_typed = True
    return lib


def ext_from_bits(case, extra):
    """Extended case code from the 8-bit corner-sign ``case`` and the packed
    ``extra`` bits (see ``extra_bits``), both int32 of one shape; returns
    int32 of that shape.  The table-only kernel of classify_ext.cu on CUDA,
    the plain lookup on the CPU."""
    if case.dtype != torch.int32 or extra.dtype != torch.int32:
        raise ValueError("ext_from_bits: case and extra must be int32")
    if case.shape != extra.shape:
        raise ValueError("ext_from_bits: case and extra must share a shape")
    if case.device.type == "cpu":
        return _ext_from_bits_plain(case, extra)
    _build.require_cuda(case, "ext_from_bits")
    _build.require_cuda(extra, "ext_from_bits")
    out = torch.empty_like(case)
    if case.numel():
        _build.check(
            _lib().sdf_ext_from_bits(
                case.data_ptr(), extra.data_ptr(), case.numel(),
                _offw(case.device).data_ptr(), out.data_ptr(),
                _build.stream_ptr(case.device),
            ),
            "ext_from_bits",
        )
        ext_from_bits.launches += 1
    return out


ext_from_bits.launches = 0


@functools.lru_cache()
def _conflicted_codes():
    """The extended codes whose derivation oracle saw a class mixture
    (``conflict_rate > 0``), so their triangulation is a majority vote.
    EMPTY with the committed tables; kept as a tripwire so a table rebuild
    that reintroduces votes surfaces per run."""
    return tuple(
        int(c) for c in np.nonzero(load_tables()["conflict_rate"] > 0)[0]
    )


def count_conflicted(ext, keep):
    """Number of kept cells whose extended code is a majority-voted
    (conflicted) table entry, as a 0-d int32 tensor on ``ext``'s device
    (no host sync: the engine fetches it with the other counts).
    Structurally 0 with the committed tables.  Surfaces as
    ``LAST_STATS['mc33_conflicted_cells']``."""
    codes = _conflicted_codes()
    if not codes:
        return torch.zeros((), dtype=torch.int32, device=ext.device)
    hit = torch.zeros(ext.shape, dtype=torch.bool, device=ext.device)
    for code in codes:
        hit |= ext == code
    return (hit & keep).sum(dtype=torch.int32)


def _corners(volume, level=0.0):
    """The 8 per-cell corner value tensors of ``volume`` (level-shifted)."""
    nx, ny, nz = volume.shape[-3:]
    return [
        volume[..., ox: nx - 1 + ox, oy: ny - 1 + oy, oz: nz - 1 + oz] - level
        for ox, oy, oz in CORNER_OFFSETS.tolist()
    ]


def _classify_ext_plain(volume, level=0.0, base_case=None):
    """B2's plain version: corner views, the case from corner compares
    unless given, ``extra_bits``, then the plain table lookup.  Some 300
    elementwise passes over grid-sized temporaries: for the tests,
    ``device="cpu"`` and the comparison on the card only."""
    c = _corners(volume, level)
    if base_case is not None:
        case = base_case
    else:
        case = torch.zeros(c[0].shape, dtype=torch.int32, device=volume.device)
        for i in range(8):
            case |= (c[i] < 0).to(torch.int32) << i
    extra = extra_bits(c)
    del c
    return _ext_from_bits_plain(case, extra)


def _launch(volume, level, base_case, lx=EXT_SLAB):
    """Kernel B2 on a CUDA ``volume`` (checked by ``classify_ext``) with
    slabs of ``lx`` cell planes; returns the ext grid."""
    _build.require_cuda(volume, "classify_ext")
    if base_case is not None:
        _build.require_cuda(base_case, "classify_ext")
    nx, ny, nz = volume.shape[-3:]
    ext = torch.empty(tuple(volume.shape[:-3]) + (nx - 1, ny - 1, nz - 1),
                      dtype=torch.int32, device=volume.device)
    if not ext.numel():
        return ext
    nb = volume.numel() // (nx * ny * nz)
    nrb, nslab, mul, shift, blocks = ext_plan(nb, nx, ny, nz, lx)
    name = "sdf_classify_ext_" + (
        "f32" if volume.dtype == torch.float32 else "f64")
    _build.check(
        getattr(_lib(), name)(
            volume.data_ptr(), nb, nx, ny, nz, lx, nrb, nslab, mul, shift,
            blocks, float(level),
            None if base_case is None else base_case.data_ptr(),
            _offw(volume.device).data_ptr(), ext.data_ptr(),
            _build.stream_ptr(volume.device),
        ),
        "classify_ext",
    )
    classify_ext.launches += 1
    return ext


def classify_ext(volume, level=0.0, base_case=None):
    """Extended case code per cell (int32, shape ``(..., nx-1, ny-1,
    nz-1)``) of a float32 or float64 ``volume`` with optional leading batch
    dims.  ``base_case`` reuses an already computed 8-bit corner-sign grid
    (kernel B1's) instead of deriving it from corner compares.  The fused
    kernel of classify_ext.cu on CUDA, the plain version on the CPU."""
    if volume.dtype not in (torch.float32, torch.float64):
        raise ValueError("classify_ext: volume must be float32 or float64")
    if volume.dim() < 3 or min(volume.shape[-3:]) < 2:
        raise ValueError("classify_ext: every grid axis needs >= 2 samples")
    nx, ny, nz = volume.shape[-3:]
    cshape = tuple(volume.shape[:-3]) + (nx - 1, ny - 1, nz - 1)
    if base_case is not None and (
        base_case.dtype != torch.int32 or tuple(base_case.shape) != cshape
        or base_case.device != volume.device
    ):
        raise ValueError(
            "classify_ext: base_case must be int32 of shape %s on the "
            "volume's device" % (cshape,)
        )
    if volume.device.type == "cpu":
        return _classify_ext_plain(volume, level, base_case)
    return _launch(volume, level, base_case)


classify_ext.launches = 0
