"""Build and load the port's CUDA kernels.

Each kernel source under ``sdf_torch/csrc/`` has a plain C interface and is
compiled at first use by ``nvcc`` into a shared library in ``BUILD``
(``build/sdf_torch/`` of the checkout unless ``set_directory``, which is
``sdf_torch.enable_compile_cache``, moved it), named by the sha256 of its
source and flags, then loaded with ``ctypes``.  Nothing here runs at
import: the CPU tests import every kernel module on machines without
``nvcc``.

Flags: ``-fmad=false`` and no fast math, so every float op rounds as the
separate PyTorch kernels of the plain versions do (bit-identical volumes,
and no FMA-contracted interpolation flipping a topology decision).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD = Path(__file__).resolve().parent.parent / "build" / "sdf_torch"
BUILD = DEFAULT_BUILD  # read under _lock, when a library is built or loaded
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs = {}  # library path -> ctypes.CDLL


def nvcc():
    """The CUDA compiler: ``$NVCC``, else ``nvcc`` on PATH, else the
    toolkit's default location."""
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def set_directory(path=None):
    """Build and find the libraries in ``path`` from now on; None restores
    ``DEFAULT_BUILD``.  Returns the directory."""
    global BUILD
    with _lock:
        BUILD = DEFAULT_BUILD if path is None else Path(path).expanduser()
        return BUILD


@functools.lru_cache(maxsize=None)
def source(name):
    """Text of a kernel source under ``csrc/`` (read once)."""
    return (CSRC / name).read_text()


def _lib_path(stem, text):
    digest = hashlib.sha256((text + " ".join(FLAGS)).encode()).hexdigest()
    return BUILD / ("%s_%s.so" % (stem, digest[:20]))


def _start(stem, text):
    """Start one nvcc build unless its library exists; returns
    ``(path, pending or None)``.

    Several processes (the ranks of a sharded run) may build one library at
    once: each writes its source and its library to files of its own, named
    by ``tempfile``, and moves the library into place atomically, so no
    ``nvcc`` reads a source that another process is rewriting."""
    so = _lib_path(stem, text)
    if so.exists():
        return so, None
    compiler = nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, cu = tempfile.mkstemp(suffix=".cu", prefix=so.stem + ".", dir=BUILD)
    with os.fdopen(fd, "w") as fp:
        fp.write(text)
    tmp = cu[: -len(".cu")] + ".so.tmp"
    proc = subprocess.Popen(
        [compiler, *FLAGS, "-o", tmp, cu],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return so, (proc, cu, tmp)


def _finish(so, pending):
    if pending is None:
        return
    proc, cu, tmp = pending
    out, _ = proc.communicate()
    os.remove(cu)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for %s:\n%s" % (so.name, out))
    os.replace(tmp, so)


def build_many(items):
    """Build ``[(stem, source text), ...]`` with one nvcc per source, all
    started together; returns the library paths."""
    with _lock:
        paths = [_lib_path(stem, text) for stem, text in items]
        unique = dict(zip(paths, items))
        started = [_start(stem, text) for stem, text in unique.values()]
        for so, pending in started:
            _finish(so, pending)
    return paths


def load(stem, text):
    """The ``ctypes`` library built from ``text`` (built on first use)."""
    with _lock:
        so = _lib_path(stem, text)
        lib = _libs.get(so)
        if lib is not None:
            return lib
    (so,) = build_many([(stem, text)])
    with _lock:
        lib = _libs.get(so)
        if lib is None:
            lib = ctypes.CDLL(str(so))
            _libs[so] = lib
    return lib


def check(rc, what):
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError("%s: CUDA error %d" % (what, rc))


def stream_ptr(device):
    """PyTorch's current stream on ``device``, as a ``c_void_p``."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(t, what):
    if t.device.type != "cuda":
        raise ValueError("%s: expected a CUDA tensor, got %s" % (what, t.device))
    if not t.is_contiguous():
        raise ValueError("%s: expected a contiguous tensor" % what)
