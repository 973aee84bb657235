"""Several processes: ``sdf_torch.parallel.initialize``,
``gather_triangles`` and ``write_on_process0`` (counterpart of
tests/test_multihost.py), ``save()`` under a mesh, and the kernel build of
several processes at once.

Two ranks join from torchrun's environment (a free port on localhost) on
gloo, generate under the auto-mesh, gather and write.  The parent holds
the result against a single-process run: the gathered soup bit-equal as a
set of triangles, the STL written once and equal to the single-process
one as a set of triangles.
"""

import datetime
import socket
import threading

import numpy as np
import pytest
import torch.distributed as dist

import sdf_torch as sp
from sdf_torch import _build, parallel
from sdf_torch.io import stl

import torch_helpers as th

KW = dict(samples=2**14, verbose=False, dtype=np.float64, device="cpu",
          bounds=((-1.1,) * 3, (1.1,) * 3))


def _no_world(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)


def test_initialize_without_a_world_is_one_process(monkeypatch):
    """No torchrun environment and no arguments: (0, 1), no process group;
    generate() then runs on one device."""
    _no_world(monkeypatch)
    assert parallel.initialize() == (0, 1)
    assert not dist.is_initialized()
    from sdf_torch.parallel import grid

    assert grid.world_mesh("cpu") is None
    with pytest.raises(RuntimeError, match="initialize"):
        parallel.make_mesh("cpu")


def test_initialize_raises_when_the_world_cannot_come_up(monkeypatch):
    """A world configured in the environment that cannot start (rank 0's
    store port is taken) raises, and leaves no process group behind."""
    _no_world(monkeypatch)
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", str(taken.getsockname()[1]))
        with pytest.raises(RuntimeError):
            parallel.initialize(backend="gloo",
                                timeout=datetime.timedelta(seconds=5))
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    return out, th.spawn_ranks(th.multihost_rank, 2, out, th.free_port())


def test_two_ranks_gather_triangles(two_ranks):
    """Each rank meshes its half (the auto-mesh of the 2-rank world);
    gather_triangles gives every triangle, bit-equal to one process's."""
    _, got = two_ranks
    single = sp.generate(sp.sphere(1), **KW)
    shares = got["counts"][:, 0]
    assert (shares > 0).all() and shares.sum() == len(single)
    assert np.array_equal(th.canon(got["full"]), th.canon(single))
    assert np.array_equal(got["full"][: shares[0]], got["share"])
    assert np.array_equal(got["saved"], got["full"])


def test_write_on_process0_writes_once(two_ranks, tmp_path):
    """write_on_process0 and save() under a mesh write from rank 0 alone;
    the STL equals the single-process one as a set of triangles."""
    out, got = two_ranks
    np.testing.assert_array_equal(got["counts"][:, 1], [2, 0])
    stl.write_binary_stl(str(tmp_path / "single.stl"),
                         sp.generate(sp.sphere(1), **KW))

    def tris(path):
        verts, faces = stl.read_binary_stl(str(path))
        return th.canon(verts[faces.reshape(-1)])

    want = tris(tmp_path / "single.stl")
    assert len(want) > 0
    for name in ("gathered.stl", "saved.stl"):
        assert np.array_equal(tris(out / name), want), name


def test_single_process_gather_is_identity():
    """Without torch.distributed, gather_triangles returns the soup as it
    is."""
    pts = np.arange(18, dtype=np.float64).reshape(6, 3)
    assert np.array_equal(parallel.gather_triangles(pts), pts)


def test_concurrent_builds_write_their_own_sources(monkeypatch, tmp_path):
    """Two builds of one library started at once (two ranks' first calls)
    write two source files, never one that the other compiler reads; each
    compiler's output is moved onto the one library path and its source
    removed."""
    started = []
    barrier = threading.Barrier(2)

    class FakeNvcc:
        returncode = 0

        def __init__(self, args, **kw):
            out, cu = args[args.index("-o") + 1], args[-1]
            with open(cu) as fp:
                started.append((cu, fp.read()))
            open(out, "w").close()

        def communicate(self):
            return "", None

    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)

    def start():
        barrier.wait()
        return _build._start("k", "int k;")

    results = []
    threads = [threading.Thread(target=lambda: results.append(start()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    (so_a, pend_a), (so_b, pend_b) = results
    assert so_a == so_b == _build._lib_path("k", "int k;")
    assert started[0][0] != started[1][0]
    assert all(text == "int k;" for _, text in started)
    _build._finish(so_a, pend_a)
    _build._finish(so_b, pend_b)
    assert so_a.exists() and not list(tmp_path.glob("*.cu"))
