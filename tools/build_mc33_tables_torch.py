#!/usr/bin/env python
"""(Re)generate sdf_torch/core/mc33_tables.npz -- the Lewiner-compatible
(trilinear-faithful) extended marching-cubes table set -- with the
PyTorch port.

See sdf_torch/core/mc33_build.py for the derivation.  The build samples
random realizations per case on the host, computes their bucket keys on
the device, resolves topology with the dense trilinear oracle (kernel L1,
csrc/label3d.cu, on the card; its plain version with --device cpu) and
records per-entry conflict rates; it is deterministic for a fixed seed and
gives the committed file's arrays.

    python3 tools/build_mc33_tables_torch.py [--out PATH] [--device cuda]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sdf_torch.core import mc33_build as mb  # noqa: E402

OUT = os.path.join(
    os.path.dirname(__file__), "..", "sdf_torch", "core", "mc33_tables.npz"
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT, help="where to write the npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the keys and the oracle")
    args = ap.parse_args(argv)
    t0 = time.time()
    tabs = mb.build_tables(
        samples_per_case=120_000, reps_per_bucket=9, oracle_n=64,
        seed=7, verbose=True, device=args.device,
    )
    dt = time.time() - t0
    n_conf = int((tabs["conflict_rate"] > 0).sum())
    print(
        f"built {mb.N_EXT} entries in {dt:.0f}s: "
        f"max_tris={tabs['tri_table'].shape[1]}, "
        f"realizable={int(tabs['realizable'].sum())}, "
        f"conflicted buckets={n_conf} "
        f"(max rate {tabs['conflict_rate'].max():.3f})"
    )
    np.savez_compressed(args.out, **tabs)
    print(f"wrote {os.path.abspath(args.out)}")


if __name__ == "__main__":
    main()
