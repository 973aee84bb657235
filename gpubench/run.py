"""The benchmark of ``sdf_torch`` on NVIDIA cards: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (start-up, kernel libraries loaded
from or built into ``build/gpubench/kernels`` inside the checkout, warm-up
requests) counts as ``setup_s``; then a closed loop of mesh requests runs
for ``--seconds``; then the sampled meshes are compared with the plain
reference (``reference/``).  The last line of standard output is one JSON
object; the numbers compared, each with its limit, are the last lines of
standard error.  ``--trace 1`` reports the per-layer metrics of a run
under ``torch.profiler`` instead of the end-to-end ones.

Exit codes: 0 a result was printed; 2 not a checkout of the repository;
3 no card, or fewer than the cell asks for; 4 the JAX package or JAX was
loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sdf_tpu")


def forbidden_modules(modules):
    """Names in ``modules`` whose top-level name (before the first dot) is
    JAX's, its libraries' or the JAX package's, compared whole."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "BENCHMARK.json").is_file() or not (
            ROOT / "sdf_torch" / "__init__.py").is_file():
        print("gpubench: run from a checkout that holds BENCHMARK.json and "
              "sdf_torch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(HERE))
    # One client process with one intra-op thread: the load stays that of
    # one process, and no idle pool of threads competes for the cores.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"

    import torch

    torch.set_num_threads(1)

    import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("gpubench: %s needs %d CUDA device(s), found %d"
              % (args.workload, cell.chips,
                 torch.cuda.device_count() if torch.cuda.is_available()
                 else 0), file=sys.stderr)
        return 3
    result, rows = harness.run(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", T_PROCESS)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print("gpubench: loaded %s" % ", ".join(bad), file=sys.stderr)
        return 4
    for name, value, limit in rows:
        print("check %s %r limit %s" % (name, value, limit), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
