"""The readings that the limits of ``correct`` are set from, in one
process: for each seed the program's numbers and the control's (the
reference in fp8 put in the program's place), each against the f32
reference, and with ``--fault-seeds`` those of the faults that the
cell's runner plants in the program.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control-seeds 1 2 3] [--fault-seeds 4]

The cell's runner (``runners/<name>.py``, chosen as ``run.py`` chooses
it) does the work in its ``calibrate``. Prints one JSON line a reading
and, last, each side's extreme of every number: the program's largest,
the control's (and each fault's) smallest.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench_port":
    sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose cell files are read")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.set_num_threads(1)
    if dev.type == "cuda":
        from dpvo_tpu_torch import kernels

        kernels.build()
    from bench_port.run import load_cell, load_module

    root = Path(args.root)
    _, config, traffic = load_cell(json.loads((root / "BENCHMARK.json").read_text()),
                                   args.workload, root)
    emit = lambda row: print(json.dumps(row), flush=True)
    runner = load_module(root, "runners", config.get("runner", "stream"))
    emit(runner.calibrate(config, traffic, args.seeds, args.control_seeds, args.fault_seeds, dev,
                          root, emit))
    return 0


if __name__ == "__main__":
    sys.exit(main())
