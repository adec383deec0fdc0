"""Where the port's tracker blocks on the card, found by PyTorch's sync
debug mode (``torch.cuda.set_sync_debug_mode("warn")``): every blocking
fetch and every blocking copy from pageable host memory warns.

    python3 scripts/sync_sites.py [--config dpvo|dpv_slam] [--seed N] [--frames T]

Tracks the first sequence of the benchmark's traffic for the configuration
(``bench_port/configs/<config>.json``, ``bench_port/traffic/eval1_walk`` or
``eval1_pan``) on the card, every call under the warn mode, then
``terminate()``. Each warning is tied to the chain of the port's frames
that made it. Prints, as JSON lines, the sites of the first steady frame
(initialized, no global BA, no cull decided), the first frame that culls a
keyframe, the first frame that runs a global-BA round and the terminate,
then every site with the number of calls it blocked in. Where the port has
its recorder (``dpvo_tpu_torch/utils/trace.py``), each call's ``sync.*``
counts are set beside the warnings (``mismatches``: the calls where they
differ).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import traceback
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
TRAFFIC = {"dpvo": "eval1_walk", "dpv_slam": "eval1_pan"}
MESSAGE = "called a synchronizing CUDA operation"


def port_chain(stack) -> str:
    """The port's frames of a stack, outermost first, as file:line function."""
    out = []
    for fr in stack:
        p = Path(fr.filename)
        if "dpvo_tpu_torch" in p.parts:
            rel = "/".join(p.parts[p.parts.index("dpvo_tpu_torch") + 1:])
            out.append(f"{rel}:{fr.lineno} {fr.name}")
    return " > ".join(out) or "outside the port"


class Recorder:
    """Each synchronizing operation's chain of port frames, while on."""

    def __init__(self):
        self.sites = []

    def __enter__(self):
        import torch

        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._show
        self.sites = []
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode("default")
        self._cm.__exit__(*exc)
        return False

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if MESSAGE in str(message):
            self.sites.append(port_chain(traceback.extract_stack()[:-1]))


def sync_counts():
    try:
        from dpvo_tpu_torch.utils import trace
    except ImportError:
        return None
    return {k: v for k, v in trace.COUNTS.items() if k.startswith("sync.")}


def delta(after, before):
    if after is None:
        return None
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="dpvo", choices=sorted(TRAFFIC))
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--frames", type=int, default=0, help="frames to track (0: the sequence)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from bench_port.run import load_module
    from dpvo_tpu_torch import kernels
    from dpvo_tpu_torch.config import Config
    from dpvo_tpu_torch.runtime.dpvo import DPVO
    from dpvo_tpu_torch.runtime.weights import load_npz

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    kernels.build()
    spec = json.loads((ROOT / f"bench_port/configs/{args.config}.json").read_text())
    traffic = json.loads((ROOT / f"bench_port/traffic/{TRAFFIC[args.config]}.json").read_text())
    cfg = Config(**spec["config"])
    gen = load_module(ROOT, "traffic", traffic["kind"])
    dev = torch.device("cuda")
    seq = gen.make_sequences(traffic, args.seed, spec["ht"], spec["wd"], cfg.RES,
                             cfg.PATCHES_PER_FRAME, cfg.PATCHES_PER_FRAME, dev)[0]
    slam = DPVO(cfg, load_npz(str(ROOT / spec["weights"])), spec["ht"], spec["wd"], device=dev,
                draws=seq.draws)
    T = args.frames or len(seq.frames)
    calls, per_site, mismatches = [], Counter(), []
    rec = Recorder()
    for t in range(T):
        init, rounds, culled = slam.is_initialized, len(slam.ran_global_ba), len(slam.delta)
        c0 = sync_counts()
        with rec:
            slam(t, seq.frames[t], seq.intrinsics)
        torch.cuda.synchronize()
        sites = rec.sites
        kind = ("gba" if len(slam.ran_global_ba) > rounds
                else "cull" if init and len(slam.delta) > culled
                else "steady" if init and slam.is_initialized else "before_init")
        counted = delta(sync_counts(), c0)
        calls.append((t, kind, sites, counted))
        for s in set(sites):
            per_site[s] += 1
        if counted is not None and sum(counted.values()) != len(sites):
            mismatches.append({"t": t, "kind": kind, "warned": len(sites), "counted": counted})
    c0 = sync_counts()
    with rec:
        slam.terminate()
    sites = rec.sites
    calls.append(("terminate", "terminate", sites, delta(sync_counts(), c0)))
    for s in set(sites):
        per_site[s] += 1
    counted = calls[-1][3]
    if counted is not None and sum(counted.values()) != len(sites):
        mismatches.append({"t": "terminate", "warned": len(sites), "counted": counted})

    first = {}
    for t, kind, sites, counted in calls:
        if kind in first or (kind == "steady" and isinstance(t, int) and t < 20):
            continue
        first[kind] = t
        print(json.dumps({"config": args.config, "call": t, "kind": kind, "syncs": len(sites),
                          "counted": counted, "sites": Counter(sites).most_common()}), flush=True)
    print(json.dumps({"config": args.config, "calls": len(calls),
                      "syncs_per_call": float(np.mean([len(c[2]) for c in calls])),
                      "sites_by_calls": per_site.most_common(),
                      "mismatches": mismatches[:20], "n_mismatches": len(mismatches)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
