"""The two readings the check's limits are set between, each the plain
reference put in the program's place:

* ``control``: its field computed in bfloat16, the precision below the
  configurations' float32, then rounded to float32 for the rest of the
  mesher.  A sound check reads it as not correct;
* ``witness``: a sound run whose float32 rounding differs from the
  program's: its field computed in float64 and rounded to float32, its
  grid moved by one float32 ulp on each axis.  A sound check reads it as
  correct.

    python3 gpubench/control.py --workload <cell> --seeds 1 2 3 [--seconds 3] [--variant witness]

runs a short window of each seed in one process, on the card, and prints
the numbers compared of each run beside their limits.  The benchmark's own
runs never run it; ``tests/test_gpubench_faults.py`` keeps both at a size
the CPU holds.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]

import torch  # noqa: E402

import harness  # noqa: E402
from reference import mesh as ref_mesh  # noqa: E402
from reference import sdf as ref_sdf  # noqa: E402


VARIANTS = {"control": dict(field_dtype=torch.bfloat16),
            "witness": dict(field_dtype=torch.float64, nudge=1)}


class Control:
    """A stand-in for the program: the reference mesher with the field and
    grid of ``variant``, returning ``(verts, faces)`` as the program
    does."""

    def __init__(self, cell, device, variant="control"):
        self.cell = cell
        self.device = device
        self.kw = VARIANTS[variant]

    def __call__(self, params):
        soup = ref_mesh.mesh(self.cell.build(ref_sdf, params),
                             int(self.cell.traffic["samples"]), self.device,
                             batch=int(self.cell.config["batch_size"]),
                             **self.kw)["soup"]
        verts = soup.reshape(-1, 3).cpu().numpy()
        return verts, torch.arange(len(verts)).reshape(-1, 3).numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--variant", choices=sorted(VARIANTS), default="control")
    args = ap.parse_args()
    cell = harness.Cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, rows = harness.run(cell, seed, args.seconds, False, "cuda",
                                   program=Control(cell, "cuda",
                                                   args.variant))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "variant": args.variant,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
