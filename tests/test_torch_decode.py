"""The mesh decode's host side on the CPU: the layout of kernel D1's one
buffer (``mc.mesh_layout``), the host's views of it (``mc.split_mesh``),
also of the host decode's own mesh, the forms ``mc.readback`` sends and
decodes on the CPU, and the counter ``card_decodes``, which reads 0
wherever the host decodes.

D1 itself runs only on a card (``tests/test_torch_cuda.py``).  Tolerance:
bit-equal everywhere.
"""

import numpy as np
import pytest
import torch

import sdf_torch as sp
from sdf_torch.core import engine, mc, sparse
from sdf_torch.models import zoo

import torch_helpers as th


@pytest.fixture(autouse=True)
def _fresh_memos():
    for memo in (engine._BOUNDS_MEMO, engine._COUNTS_MEMO,
                 engine._SKIP_MEMO, sparse._COUNTS_MEMO):
        memo.clear()


@pytest.mark.parametrize("ne, n", [(0, 0), (0, 1), (1, 0), (1, 1), (2, 3),
                                   (5, 8), (1000003, 2000006)])
def test_mesh_layout(ne, n):
    """24 bytes a vertex, then 12 a face, padded to whole 8-byte words."""
    vbytes, nbytes = mc.mesh_layout(ne, n)
    assert vbytes == 24 * ne
    assert nbytes % 8 == 0 and 0 <= nbytes - (24 * ne + 12 * n) < 8


@pytest.mark.parametrize("dtype, device, ne, want", [
    (torch.float32, "cuda", 5, "card"),
    (torch.float32, "cuda", 1 << 22, "card"),
    (torch.float32, "cpu", (1 << 21) - 1, True),
    (torch.float32, "cpu", 1 << 21, "wide"),
    (torch.float64, "cuda", 5, False),
    (torch.float64, "cpu", 5, False)])
def test_wire_format(dtype, device, ne, want):
    """D1 for float32 on a card; the packed formats on the CPU; float64
    vertices as they are."""
    got = mc.wire_format(dtype, torch.device(device), ne)
    assert got == want and type(got) is type(want)


def _hand_made(ne, n, seed=0):
    """A buffer laid out by hand: distinct float64 vertices (NaN and -0.0
    among them when there is room), distinct int32 faces, then padding."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((ne, 3))
    if ne:
        v.reshape(-1)[:2] = [np.nan, -0.0][: v.size]
    f = rng.integers(-2**31, 2**31, (n, 3), dtype=np.int64).astype(np.int32)
    raw = v.tobytes() + f.tobytes()
    pad = mc.mesh_layout(ne, n)[1] - len(raw)
    return v, f, np.frombuffer(raw + b"\xa5" * pad, np.uint8).copy()


@pytest.mark.parametrize("ne, n", [(0, 0), (0, 3), (4, 0), (5, 7), (6, 8)])
def test_split_mesh_views_a_hand_made_buffer(ne, n):
    v, f, buf = _hand_made(ne, n)
    vh, fh = mc.split_mesh(buf, ne, n)
    assert vh.shape == (ne, 3) and vh.dtype == np.float64
    assert fh.shape == (n, 3) and fh.dtype == np.int32
    np.testing.assert_array_equal(vh.view(np.int64), v.view(np.int64))
    np.testing.assert_array_equal(fh, f)
    # views of the fetched bytes, not copies
    for a in (vh, fh):
        assert a.size == 0 or np.shares_memory(a, buf)


@pytest.mark.parametrize("change", ["short", "long", "dtype"])
def test_split_mesh_refuses_another_buffer(change):
    _, _, buf = _hand_made(3, 5)
    bad = {"short": buf[:-8], "long": np.concatenate([buf, buf[:8]]),
           "dtype": buf.view(np.int32)}[change]
    with pytest.raises(ValueError):
        mc.split_mesh(bad, 3, 5)


def test_decode_on_card_refuses_host_tensors():
    eidx = torch.zeros(4, dtype=torch.int32)
    t = torch.zeros(4, dtype=torch.float32)
    faces = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        mc.decode_on_card(eidx, t, faces, 4, 4, grid_shape=(2, 2, 2))


def _spy(monkeypatch, module, name):
    """Record each call's arguments and result of ``module.name``."""
    calls = []
    real = getattr(module, name)

    def spy(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("route", ["dense", "tiles"])
def test_split_mesh_gives_back_the_host_decode(monkeypatch, route):
    """The host decode's vertices and faces of a CPU call, laid out as
    kernel D1 writes them (``mesh_layout``), come back from ``split_mesh``
    bit for bit."""
    if route == "dense":
        calls = _spy(monkeypatch, mc, "unpack_indexed")
        th.example(sp).generate(samples=2**15, sparse=False, verbose=False,
                                device="cpu")
    else:
        calls = _spy(monkeypatch, sparse, "unpack_tiles_indexed")
        zoo.blobby().generate(samples=2**17, sparse="tiles", batch_size=8,
                              verbose=False, device="cpu")
    ((_, (vh, fh)),) = calls
    ne, n = len(vh), len(fh)
    assert ne > 0 and n > 0
    raw = np.ascontiguousarray(vh).tobytes() + np.ascontiguousarray(
        fh).tobytes()
    buf = np.zeros(mc.mesh_layout(ne, n)[1], np.uint8)
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    got_v, got_f = mc.split_mesh(buf, ne, n)
    np.testing.assert_array_equal(got_v.view(np.int64), vh.view(np.int64))
    np.testing.assert_array_equal(got_f, fh)


@pytest.mark.parametrize("dtype, bits, want", [
    (torch.float32, mc.FACE_PACK_BITS, 2), (torch.float32, 2, 3),
    (torch.float64, mc.FACE_PACK_BITS, None)])
def test_readback_on_the_cpu(monkeypatch, dtype, bits, want):
    """On the CPU ``readback`` sends float32 as the wire format, (edge id,
    t bits) a vertex and ``want`` face words (three 21-bit ranks in two
    words, or the three ranks once ``ne`` reaches ``2**FACE_PACK_BITS``),
    and decodes it with the ``unpack`` it is given; float64 sends
    ``plain()``'s vertices and the ranks, and decodes them itself."""
    monkeypatch.setattr(mc, "FACE_PACK_BITS", bits)
    ne, n, cap = 5, 4, 8
    eidx = torch.arange(3, 3 + cap, dtype=torch.int32)
    t = torch.linspace(0, 1, cap, dtype=dtype)
    faces = torch.arange(3 * cap, dtype=torch.int32).reshape(3, cap) % ne
    everts = torch.arange(3 * cap, dtype=dtype).reshape(3, cap) / 7
    got = []

    def unpack(e, f):
        got.append((e, f))
        return "decoded"

    tensors, decode = mc.readback(eidx, t, faces, ne, n, plain=lambda: everts,
                                  unpack=unpack, grid_shape=(4, 4, 4))
    arrays = [x.numpy() for x in tensors]
    if want is None:
        vh, fh = decode(arrays)
        assert not got and vh.dtype == np.float64 and fh.dtype == np.int32
        np.testing.assert_array_equal(vh, everts[:, :ne].T.numpy())
        np.testing.assert_array_equal(fh, faces[:, :n].T.numpy())
        return
    assert decode(arrays) == "decoded"
    ((e, f),) = got
    assert e.dtype == f.dtype == np.uint32
    assert e.shape == (2, ne) and f.shape == (want, n)
    np.testing.assert_array_equal(e[0], eidx[:ne].numpy())
    np.testing.assert_array_equal(e[1].view(np.float32), t[:ne].numpy())
    np.testing.assert_array_equal(mc.unpack_faces(f), faces[:, :n].T.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("route", [False, "tiles", "routed"])
def test_a_cpu_call_decodes_on_the_host(monkeypatch, route, dtype):
    """On the CPU no mesh is decoded by D1: ``card_decodes`` reads 0, and a
    float32 mesh comes through the numpy decode of the wire format."""
    dense = _spy(monkeypatch, mc, "unpack_indexed")
    tiled = _spy(monkeypatch, sparse, "unpack_tiles_indexed")
    if route == "routed":
        sp.sphere(0.1).generate(samples=2**15, bounds=((-3.0,) * 3,
                                                       (3.0,) * 3),
                                batch_size=8, verbose=False, device="cpu",
                                dtype=dtype)
        assert "auto_tiles" in engine.LAST_STATS
    else:
        th.example(sp).generate(samples=2**14, sparse=route, batch_size=8,
                                verbose=False, device="cpu", dtype=dtype)
    st = engine.LAST_STATS
    assert st["triangles"] > 0 and st["card_decodes"] == 0
    host = len(tiled) if route else len(dense)
    assert host == (dtype == torch.float32)
    assert len(dense) + len(tiled) == host
