"""The port stands alone: no JAX, no sdf_tpu, no quiet CPU fallback."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KERNEL_MODULES = [
    "sdf_torch._build",
    "sdf_torch.core.eval_classify",
    "sdf_torch.core.hybrid",
    "sdf_torch.core.sparse",
    "sdf_torch.core.mc",
    "sdf_torch.core.mc33",
    "sdf_torch.core.mc33_build",
    "sdf_torch.core.compact",
    "sdf_torch.core.engine",
    "sdf_torch.utils.checkpoint",
    "sdf_torch.io.meshfmt",
    "sdf_torch.models.zoo",
    "sdf_torch.core.node",
    "sdf_torch.ops.shapes2",
    "sdf_torch.ops.textures",
    "sdf_torch.ops.meshsdf",
    "sdf_torch.core.diffmesh",
    "sdf_torch.models.fit",
    "sdf_torch.parallel",
    "sdf_torch.parallel.grid",
    "sdf_torch.parallel.sparse",
    "sdf_torch.parallel.shards",
    "sdf_torch.parallel.multihost",
]


def test_import_leaves_jax_out():
    code = (
        "import sys, sdf_torch\n"
        "from sdf_torch import *\n"
        "import sdf_torch.core.engine, sdf_torch.core.eval_classify\n"
        "import sdf_torch.core.mc33, sdf_torch.core.mc33_build\n"
        "import sdf_torch.utils.checkpoint, sdf_torch.io.meshfmt\n"
        "import sdf_torch.models.zoo\n"
        "import sdf_torch.core.sparse, sdf_torch.core.hybrid\n"
        "import sdf_torch.ops.shapes2, sdf_torch.ops.textures\n"
        "import sdf_torch.ops.meshsdf\n"
        "import sdf_torch.core.diffmesh, sdf_torch.models.fit\n"
        "import sdf_torch.parallel.grid, sdf_torch.parallel.sparse\n"
        "import sdf_torch.parallel.shards, sdf_torch.parallel.multihost\n"
        "sdf_torch.core.mc.get_tables('lewiner')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'jaxlib', 'sdf_tpu'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "sdf_torch")):
        paths += [os.path.join(dirpath, n) for n in files if n.endswith(".py")]
    return paths


def test_sources_name_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax or sdf_tpu,
    even lazily."""
    paths = _port_sources()
    names = {os.path.relpath(p, ROOT) for p in paths}
    assert {"chip_smoke.py", "sdf_torch/core/mc33.py",
            "sdf_torch/core/mc33_build.py", "sdf_torch/utils/checkpoint.py",
            "sdf_torch/io/meshfmt.py", "sdf_torch/models/zoo.py",
            "sdf_torch/core/sparse.py", "sdf_torch/core/hybrid.py",
            "sdf_torch/ops/shapes2.py", "sdf_torch/ops/textures.py",
            "sdf_torch/ops/meshsdf.py", "sdf_torch/core/diffmesh.py",
            "sdf_torch/models/fit.py", "sdf_torch/parallel/grid.py",
            "sdf_torch/parallel/sparse.py", "sdf_torch/parallel/shards.py",
            "sdf_torch/parallel/multihost.py"} <= names
    for path in paths:
        with open(path) as fp:
            for line in fp:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    assert "jax" not in s and "sdf_tpu" not in s, (path, s)


def test_kernel_sources_are_shipped_and_named():
    """Every kernel source the wrappers build exists under csrc/ and says
    which TPU kernel it replaces."""
    csrc = os.path.join(ROOT, "sdf_torch", "csrc")
    for name in ("eval_classify.cu", "ntri.cu", "compact.cu",
                 "classify_ext.cu", "eval_tiles.cu"):
        with open(os.path.join(csrc, name)) as fp:
            text = fp.read()
        assert "Replaces: sdf_tpu/" in text, name
        assert "extern \"C\"" in text, name
    # every file under csrc/ is one the wrappers build or splice, and the
    # package data ships each of them (*.cu does not match the .cuh)
    assert sorted(os.listdir(csrc)) == [
        "classify_ext.cu", "compact.cu", "eval_classify.cu", "eval_tiles.cu",
        "mc33_cell.cuh", "ntri.cu", "sdf_point.cuh"]
    with open(os.path.join(ROOT, "pyproject.toml")) as fp:
        shipped = fp.read()
    assert '"csrc/*.cu"' in shipped and '"csrc/*.cuh"' in shipped
    with open(os.path.join(csrc, "eval_tiles.cu")) as fp:
        text = fp.read()
    for entry in ("sdf_eval_tiles_f32", "sdf_eval_tiles_f64",
                  "sdf_eval_tiles_fields_f32", "sdf_eval_tiles_fields_f64",
                  "pallas_eval.py `_tile_kernel_batched`",
                  "pallas_eval.py `_tile_kernel`"):
        assert entry in text, entry
    with open(os.path.join(csrc, "sdf_point.cuh")) as fp:
        point = fp.read()
    assert "//@SDF_BODY@" in point and "fast_math" not in point
    for name in ("eval_classify.cu", "eval_tiles.cu"):
        with open(os.path.join(csrc, name)) as fp:
            assert fp.read().count('#include "sdf_point.cuh"') == 1, name
    with open(os.path.join(csrc, "classify_ext.cu")) as fp:
        text = fp.read()
    for entry in ("sdf_classify_ext_f32", "sdf_classify_ext_f64",
                  "sdf_ext_from_bits"):
        assert entry in text
    assert text.count('#include "mc33_cell.cuh"') == 1
    with open(os.path.join(csrc, "mc33_cell.cuh")) as fp:
        text += fp.read()
    for body in ("interior_code", "root_flags", "face_joined", "extra_bits",
                 "ext_combine", "clamp0"):
        assert body + "(" in text, body
    assert "fast_math" not in text and "__fmaf" not in text


@pytest.mark.parametrize("module", KERNEL_MODULES)
def test_kernel_modules_import_without_nvcc(module):
    env = dict(os.environ, PATH="/nonexistent")
    env.pop("NVCC", None)
    r = subprocess.run([sys.executable, "-c", "import " + module], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    import sdf_torch as sp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sp.sphere(1).generate(samples=2**10, verbose=False, mc_variant="fast",
                              device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        sp.sphere(1).generate(samples=2**10, verbose=False, mc_variant="fast")
    with pytest.raises(RuntimeError, match="CUDA"):
        sp.sphere(1).generate(samples=2**10, verbose=False)  # every default


def test_point_call_defaults_to_card(monkeypatch):
    """``f(points)`` puts host points on the card unless told otherwise;
    without a card that raises.  A tensor keeps its own device."""
    import sdf_torch as sp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    f = sp.sphere(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        f(pts)
    with pytest.raises(RuntimeError, match="CUDA"):
        f(torch.as_tensor(pts), device="cuda")
    want = np.array([[-1.0], [1.0]])
    np.testing.assert_array_equal(f(pts, device="cpu").numpy(), want)
    np.testing.assert_array_equal(f(torch.as_tensor(pts)).numpy(), want)


def test_wrappers_never_fall_back():
    """A tensor on a device that is neither the CPU nor CUDA is refused, not
    computed by the plain version."""
    from sdf_torch.core import compact, eval_classify, mc, mc33

    meta_case = torch.zeros(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        mc.ntri_of(meta_case)
    with pytest.raises(ValueError):
        mc.ntri_of(meta_case, "lewiner")
    with pytest.raises(ValueError):
        mc33.ext_from_bits(meta_case, meta_case)
    for dtype in (torch.float32, torch.float64):
        vol = torch.zeros((4, 4, 4), dtype=dtype, device="meta")
        with pytest.raises(ValueError):
            mc33.classify_ext(vol)
        with pytest.raises(ValueError):
            mc33.classify_ext(
                vol, base_case=torch.zeros((3, 3, 3), dtype=torch.int32,
                                           device="meta"))
    with pytest.raises(ValueError):
        compact.indices_and_ranktable_of(
            torch.zeros(16, dtype=torch.bool, device="meta"), 4
        )
    X = np.linspace(-1, 1, 4)
    with pytest.raises(ValueError):
        eval_classify.eval_and_classify(
            __import__("sdf_torch").sphere(1), X, X, X, torch.float32, "meta"
        )
    tiles = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    for wrapper in (eval_classify.eval_tiles_and_classify_batched,
                    eval_classify.eval_tiles_and_classify):
        with pytest.raises(ValueError, match="device"):
            wrapper(__import__("sdf_torch").sphere(1), X, X, X, tiles, 2,
                    torch.float32)


def test_tile_wrappers_launch_on_cuda_tensors_only(monkeypatch):
    """On the CPU the tile wrappers run the plain version; on any other
    tensor they go to the launch (no try/except around it, no plain version
    behind it): with the launch stubbed, a CUDA-typed call reaches the stub
    and a CPU call does not."""
    from sdf_torch.core import eval_classify

    reached = []
    monkeypatch.setattr(eval_classify, "_launch_tiles",
                        lambda *a: reached.append(a[-1]) or (None, None))

    class FakeCuda:
        type = "cuda"

    class FakeTiles:
        dtype, shape, device = torch.int32, (2, 3), FakeCuda()

        def dim(self):
            return 2

    f = __import__("sdf_torch").sphere(1)
    X = np.linspace(-1, 1, 9)
    b6 = eval_classify.eval_tiles_and_classify_batched
    b7 = eval_classify.eval_tiles_and_classify
    assert b6(f, X, X, X, FakeTiles(), 4, torch.float32) == (None, None)
    assert b7(f, X, X, X, FakeTiles(), 4, torch.float32) == (None, None)
    assert reached == [b6, b7]
    cpu = torch.zeros((2, 3), dtype=torch.int32)
    vols, case = b6(f, X, X, X, cpu, 4, torch.float32)
    assert vols.shape == (2, 5, 5, 5) and reached == [b6, b7]
    src = open(eval_classify.__file__).read()
    assert "except" not in src


def test_launch_counters_start_at_zero_on_cpu():
    """CPU runs use the plain versions and count no launches."""
    import sdf_torch as sp
    from sdf_torch.core import compact, eval_classify, mc

    from sdf_torch.core import mc33

    wrappers = [eval_classify.eval_and_classify, mc.ntri_of,
                compact.indices_of, compact.indices_and_ranktable_of,
                mc33.classify_ext, mc33.ext_from_bits,
                eval_classify.eval_tiles_and_classify_batched,
                eval_classify.eval_tiles_and_classify]
    before = [w.launches for w in wrappers]
    for variant in ("fast", "lewiner"):
        for sparse in (True, "tiles"):
            sp.sphere(1).generate(samples=2**12, verbose=False, sparse=sparse,
                                  mc_variant=variant, device="cpu")
    z = torch.zeros(8, dtype=torch.int32)
    mc33.ext_from_bits(z, z)
    assert [w.launches for w in wrappers] == before


def test_build_needs_nvcc(monkeypatch, tmp_path):
    from sdf_torch import _build

    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_build_many_starts_one_nvcc_per_distinct_source(monkeypatch, tmp_path):
    """Identical sources share one build; every item gets its library path.
    A stand-in compiler records its calls and writes the output file."""
    from sdf_torch import _build

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
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    items = [("a", "int a;"), ("b", "int b;"), ("a", "int a;")]
    paths = _build.build_many(items)
    assert len(paths) == 3 and paths[0] == paths[2] != paths[1]
    assert all(p.exists() for p in paths)
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    assert all("-fmad=false" in c and "arch=compute_90a,code=sm_90a" in c
               for c in calls)
    # a second request finds the libraries and compiles nothing
    _build.build_many(items)
    assert len(log.read_text().splitlines()) == 2


def test_texture_libraries_load_lazily():
    """PIL and scipy are imported inside the texture functions, as in the
    JAX package: importing the port (every name of it) loads neither."""
    code = (
        "import sys\n"
        "from sdf_torch import *\n"
        "import sdf_torch.ops.textures, sdf_torch.ops.meshsdf\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('PIL', 'scipy')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_one_pass_ranktable_and_no_try_around_a_launch():
    """Kernel B5's wrapper launches one kernel and scans nothing with a
    library call; neither compaction nor eval wrapper catches an error
    from a launch (so nothing gives way to a plain version)."""
    import inspect

    from sdf_torch.core import compact, eval_classify

    src = inspect.getsource(compact._ranktable_cuda)
    assert "cumsum" not in src and src.count("lib.sdf_compact_") == 1
    for mod in (compact, eval_classify):
        assert "except" not in inspect.getsource(mod), mod.__name__
    from sdf_torch import _build

    assert "count_kernel" not in _build.source("compact.cu")


def test_no_branch_waits_for_the_multi_gpu_port():
    """Every entry point of the multi-GPU port runs: no module of the port
    raises NotImplementedError naming ROADMAP A14 any more."""
    for path in _port_sources():
        with open(path) as fp:
            text = fp.read()
        assert "A14" not in text, path
