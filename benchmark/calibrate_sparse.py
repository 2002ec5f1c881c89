"""The readings behind the sparse configuration's limits of ``correct``:
``benchmark/calibrate.py``'s loop and output over the sparse substrate, the
network's parameter shapes ``PaSCoNet``'s and the program held against
:class:`~benchmark.reference.sparse_model.SparseReference` (the control is
that reference in float8).

    python3 benchmark/calibrate_sparse.py --workload sparse_single_scan --seeds 1-16 \
        --control-seeds 1-3 [--out build/calibrate_sparse_single_scan.json]
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from benchmark import calibrate, program
    from benchmark.kinds.eval_scans_sparse import parameter_shapes, swapped
    from benchmark.reference import model
    from benchmark.reference.sparse_model import SparseReference

    # calibrate.readings takes program.parameter_shapes and
    # model.Reference by name when it is called
    with swapped(program, parameter_shapes=parameter_shapes), \
            swapped(model, Reference=SparseReference):
        return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
