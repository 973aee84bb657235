"""``sdf_torch.enable_compile_cache``: the directory the CUDA kernels are
built into and loaded from.  Driven on the CPU with a stand-in compiler
(records its calls, writes the output file) and the stand-in library of
the launch-count tests (tests/test_torch_compact.py), so no nvcc runs."""

import pytest

import sdf_torch as sp
from sdf_torch import _build

from test_torch_compact import _FakeLib


@pytest.fixture
def stand_ins(monkeypatch, tmp_path):
    """A compiler that writes empty libraries, ctypes loading the stand-in
    library, and an empty set of loaded libraries; the build directory is
    restored afterwards."""
    log = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "echo \"$@\" >> %s\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then touch \"$2\"; fi\n"
        "  shift\n"
        "done\n" % log
    )
    fake.chmod(0o755)
    monkeypatch.setenv("NVCC", str(fake))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _FakeLib())
    monkeypatch.setattr(_build, "_libs", {})
    yield log
    sp.enable_compile_cache(None)


def test_enable_compile_cache_moves_the_build_directory(stand_ins, tmp_path):
    """Libraries are built into and loaded from the directory given; a
    second load there compiles nothing."""
    cache = tmp_path / "cache"
    assert sp.enable_compile_cache(str(cache)) == cache == _build.BUILD
    lib = _build.load("k", "int k;")
    built = list(cache.glob("k_*.so"))
    assert len(built) == 1 and _build._lib_path("k", "int k;") == built[0]
    assert isinstance(lib, _FakeLib)
    assert _build.load("k", "int k;") is lib
    assert len(stand_ins.read_text().splitlines()) == 1
    lib.sdf_entry()
    assert lib.calls == ["sdf_entry"]


def test_none_restores_the_default(stand_ins, tmp_path):
    """``enable_compile_cache(None)`` goes back to build/sdf_torch beside
    the package, where chip_smoke.py builds; paths follow at once."""
    sp.enable_compile_cache(tmp_path / "elsewhere")
    assert _build._lib_path("k", "int k;").parent == tmp_path / "elsewhere"
    assert sp.enable_compile_cache() == _build.DEFAULT_BUILD == _build.BUILD
    assert _build._lib_path("k", "int k;").parent == _build.DEFAULT_BUILD
    assert _build.DEFAULT_BUILD.parts[-2:] == ("build", "sdf_torch")


def test_build_many_follows_the_directory(stand_ins, tmp_path):
    """build_many puts every library of one call in the directory in force
    when it is called, one compile per distinct source."""
    sp.enable_compile_cache(tmp_path / "a")
    paths = _build.build_many([("a", "int a;"), ("b", "int b;"),
                               ("a", "int a;")])
    assert all(p.parent == tmp_path / "a" and p.exists() for p in paths)
    assert paths[0] == paths[2] != paths[1]
    assert len(stand_ins.read_text().splitlines()) == 2
